"""3D math (counterpart of ``latentfusion_tpu.three``)."""
from .core import (  # noqa: F401
    acos_safe,
    dehomogenize,
    ensure_batch_dim,
    grid_to_coords,
    homogenize,
    inner_product,
    linspace,
    normalize,
    points_bound,
    points_bounding_size,
    points_centroid,
    points_diameter,
    points_radius,
    spherical_to_cartesian,
    transform_coord_grid,
    transform_coords,
    uniform,
    uniform_unit_vector,
)
from . import stats  # noqa: F401
from . import quaternion  # noqa: F401
from .rigid import (  # noqa: F401
    decompose,
    extrinsic_to_position,
    extrinsic_to_quat,
    intrinsic_to_3x4,
    inverse_transform,
    matrix_3x3_to_4x4,
    random_translation,
    rotation_to_4x4,
    scale_matrix,
    to_extrinsic_matrix,
    translate_matrix,
    translation_to_4x4,
)
from .batchview import b2bv, bv2b, bvmm, vcat, vsplit  # noqa: F401
from . import orientation  # noqa: F401
from . import utils  # noqa: F401
from . import host  # noqa: F401
