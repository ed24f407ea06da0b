"""build.load_s: seconds of the seed file's load inside
``Application.initialize()``: the JSONL parse, the shred and the host
postings (``FileLoader.load_file``), less the device build that runs
inside it (``build.device_s``). The program's ``build.load`` stage."""

from portbench import buildstages

NAME = "build.load_s"
UNIT = "s"
BETTER = "lower"
LAYER = "build"
MOVES = "setup_s"
SOURCE = "program_span"
TARGET = "mygramdb_tpu_torch.utils.trace:stage build.load"


def read(obs):
    return buildstages.seconds({"build.load"}, own=True)
