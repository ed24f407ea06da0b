"""text.device_gb: the text store's device bytes, in GB: the padded matrix
or the flat pack, offsets, lengths and the overflow row, as the program's
gauge ``text_store_bytes`` (``mygramdb_tpu_torch.ops.runtime``) holds them
for the tables built in this process. A program without the gauge reads
None."""

NAME = "text.device_gb"
UNIT = "GB"
BETTER = "lower"
LAYER = "text"
MOVES = "device_gb"
SOURCE = "program_span"
TARGET = "mygramdb_tpu_torch.storage.device_text:DeviceTextStore.memory_usage"


def read(obs):
    from mygramdb_tpu_torch.ops import runtime
    gauge = getattr(runtime, "text_store_bytes", None)
    if not gauge:
        return None
    return sum(gauge.values()) / 1e9
