"""Distribution utilities beyond the partition specs.

- ``pipeline``: GPipe-style pipeline parallelism over the ranks of one
  mesh axis, the microbatches rotated by ``distributed.ppermute``.
- ``compression``: int8-quantized gradient all-reduce with error feedback.
- re-exports the partition-spec machinery from ``models.common`` so
  callers have one import point, as the reference's ``parallel``.
"""

from ..models.common import (STRATEGIES, batch_spec, constrain,
                             mesh_shape_dict, resolve_spec, specs_for)
from .compression import compressed_psum, make_compressed_grad_transform
from .pipeline import pipeline_apply

__all__ = [
    "STRATEGIES", "batch_spec", "constrain", "mesh_shape_dict",
    "resolve_spec", "specs_for", "pipeline_apply", "compressed_psum",
    "make_compressed_grad_transform",
]
