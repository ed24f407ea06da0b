"""text.build_s: seconds inside ``Application.initialize()`` spent packing
the normalized texts and putting the text store on the device (the flat
pack, the padded matrix built from it, offsets, lengths and the overflow
row): the program's ``build.device`` stage with ``what: text``."""

NAME = "text.build_s"
UNIT = "s"
BETTER = "lower"
LAYER = "text"
MOVES = "setup_s"
SOURCE = "program_span"
TARGET = "mygramdb_tpu_torch.catalog:TableContext._rebuild_device_text"


def read(obs):
    try:
        from mygramdb_tpu_torch.utils import trace
    except ImportError:
        return None
    stages = trace.build_stages()
    init = [s for s in stages if s.name == "build.initialize"]
    if not init:
        return None
    last = init[-1]
    text = [s for s in stages if s.name == "build.device"
            and s.attrs.get("what") == "text"
            and last.start <= s.start and s.end <= last.end]
    return sum(s.seconds for s in text) if text else None
