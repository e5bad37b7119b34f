"""The data layer (counterpart of ``latentfusion_tpu/data``): the host
rasterizer and renderer, the synthetic training stream, its loader, and the
BOP, KinectFusion and triplet datasets. The COLMAP and Realsense loaders
are not ported."""
from . import (  # noqa: F401
    bop,
    kinectfusion,
    loader,
    rasterizer,
    rendering,
    synthetic,
    triplet,
)
from .bop import BOPDataset  # noqa: F401
from .kinectfusion import KinectFusionDataset  # noqa: F401
from .loader import IterableLoader, collate  # noqa: F401
from .rendering import Renderer, SceneContext, load_object  # noqa: F401
from .synthetic import (  # noqa: F401
    BOPTrainDataset,
    ModelNetDataset,
    ShapeNetDataset,
    SyntheticDataset,
    YCBDataset,
)
from .triplet import TripletDataset  # noqa: F401
