"""The error a kernel wrapper raises when its kernel refuses its inputs or
fails to launch.

It is a ``PipelineError``, the class the query pipeline's device fast
paths re-raise (``_try_topn``, ``_try_count``): a kernel failure becomes
the query's ERROR answer and is never retried on the host path. Other
exceptions from those fast paths are retried on the host path when the
query carries filter rows (a segment swap raced the query).

Only the kernel wrappers import this module, and only when they raise:
the pipeline's own import chain reaches ``ops``, so ``ops`` cannot import
the pipeline at its top level.
"""

from ..query.pipeline import PipelineError


class KernelError(PipelineError):
    pass
