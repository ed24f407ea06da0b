"""build.warmup_s: seconds of ``DeviceIndex.warmup()`` inside
``Application.initialize()`` (the dense, sparse and boolean programs run
once before serving): the program's ``build.warmup`` stage."""

from portbench import buildstages

NAME = "build.warmup_s"
UNIT = "s"
BETTER = "lower"
LAYER = "build"
MOVES = "setup_s"
SOURCE = "program_span"
TARGET = "mygramdb_tpu_torch.index.device_index:DeviceIndex.warmup"


def read(obs):
    return buildstages.seconds({"build.warmup"})
