"""CLI entry point (reference app/command_line_parser + src/main.cpp:20).

    mygramdb-tpu --config config.yaml [--seed data.jsonl] [--restore x.dmp]
    mygramdb-tpu --config config.yaml --config-test
"""

from __future__ import annotations

import argparse
import sys

from .. import __version__
from ..utils.errors import ConfigError


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mygramdb-tpu",
        description="TPU-native in-memory n-gram full-text search engine "
                    "with MySQL binlog replication")
    p.add_argument("-c", "--config", required=False,
                   help="path to YAML/JSON config file")
    p.add_argument("--config-test", action="store_true",
                   help="validate the config file and exit")
    p.add_argument("--seed", help="seed data file (JSONL/TSV) to load when "
                                  "tables are empty")
    p.add_argument("--restore", help="dump file to restore on startup")
    p.add_argument("-d", "--daemon", action="store_true",
                   help="daemonize (requires logging.file)")
    p.add_argument("--allow-root", action="store_true",
                   help="override the refusal to run as root (containers "
                        "with a root-only user; also MYGRAM_ALLOW_ROOT=1)")
    p.add_argument("-V", "--version", action="version",
                   version=f"mygramdb-tpu {__version__}")
    return p


def check_root_privilege(allow_root: bool = False) -> bool:
    """Refuse to run as root (reference application.cpp:296-311
    CheckRootPrivilege): a network-facing in-memory database has no
    business with uid 0. Unlike the reference, an explicit opt-out
    (--allow-root / MYGRAM_ALLOW_ROOT=1) exists for single-user
    containers. Returns True when startup may proceed."""
    import os
    if allow_root or os.environ.get("MYGRAM_ALLOW_ROOT") == "1":
        return True
    getuid = getattr(os, "getuid", None)
    geteuid = getattr(os, "geteuid", None)
    if getuid is None or geteuid is None:  # non-POSIX
        return True
    if getuid() != 0 and geteuid() != 0:
        return True
    print("ERROR: Running mygramdb-tpu as root is not allowed for "
          "security reasons.\n"
          "Run as a dedicated non-privileged user (systemd User=, "
          "Docker USER, or sudo -u mygramdb ...),\n"
          "or pass --allow-root / set MYGRAM_ALLOW_ROOT=1 to override "
          "in single-user containers.", file=sys.stderr)
    return False


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if not args.config:
        print("error: --config is required", file=sys.stderr)
        return 2
    from ..config import load_config
    try:
        config = load_config(args.config)
    except ConfigError as e:
        print(f"config error: {e.message}", file=sys.stderr)
        return 1
    if args.config_test:
        print("config OK")
        return 0
    if not check_root_privilege(args.allow_root):
        return 1
    if args.daemon:
        if not config.logging.file:
            print("error: --daemon requires logging.file", file=sys.stderr)
            return 1
        import os
        if os.fork() > 0:
            return 0
        os.setsid()
        if os.fork() > 0:
            return 0
    from .application import Application
    app = Application(config, seed_path=args.seed, restore_dump=args.restore)
    app.register_stack_dump_signal()  # before slow warmup compiles
    app.initialize()
    return app.run()


if __name__ == "__main__":
    sys.exit(main())
