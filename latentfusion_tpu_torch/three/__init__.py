"""3D math (counterpart of ``latentfusion_tpu.three``)."""
from .core import (  # noqa: F401
    acos_safe,
    ensure_batch_dim,
    inner_product,
    normalize,
    transform_coords,
)
from . import quaternion  # noqa: F401
from . import orientation  # noqa: F401
from .rigid import (  # noqa: F401
    intrinsic_to_3x4,
    rotation_to_4x4,
    to_extrinsic_matrix,
    translation_to_4x4,
)
from .batchview import b2bv, bv2b  # noqa: F401
