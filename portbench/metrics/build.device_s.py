"""build.device_s: seconds inside ``Application.initialize()`` spent
putting the index (and, on a verified table, the text store) on the
device, the kernel library's build or load included: the program's
``build.device`` stages and ``build.kernels``."""

from portbench import buildstages

NAME = "build.device_s"
UNIT = "s"
BETTER = "lower"
LAYER = "build"
MOVES = "setup_s"
SOURCE = "program_span"
TARGET = "mygramdb_tpu_torch.utils.trace:stage build.device"


def read(obs):
    return buildstages.seconds({"build.device", "build.kernels"})
