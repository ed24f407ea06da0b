from .file_loader import FileLoader, load_seed_file, make_sync_loader

__all__ = ["FileLoader", "load_seed_file", "make_sync_loader"]
