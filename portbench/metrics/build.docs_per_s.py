"""build.docs_per_s: documents loaded and indexed a second: the corpus's
documents over the host seconds of ``Application.initialize()`` (the file
loader, the host index build, the device upload and the warm-up), which
``setup_s`` holds."""

NAME = "build.docs_per_s"
UNIT = "docs/s"
BETTER = "higher"
LAYER = "build"
MOVES = "setup_s"
SOURCE = "host_clock"
TARGET = "mygramdb_tpu_torch.app.application:Application.initialize"


def read(obs):
    b = obs["build"]
    if not b or not b["initialize_s"]:
        return None
    return b["docs"] / b["initialize_s"]
