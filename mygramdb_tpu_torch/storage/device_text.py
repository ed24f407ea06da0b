"""Placeholder for ``mygramdb_tpu.storage.device_text`` (the packed text
store for device verify and BM25): ROADMAP Queue 1, item 7.

``DeviceTextStore.from_doc_store`` raises NotImplementedError; the
catalog then logs ``device_text_build_failed`` and the pipeline verifies
text on the host, as the JAX package does when its pack cannot be built.
"""

from .._overlay import not_ported, placeholder_getattr


class DeviceTextStore:
    from_doc_store = staticmethod(
        not_ported(__name__, "DeviceTextStore.from_doc_store", "7"))


__getattr__ = placeholder_getattr(__name__, "7")
