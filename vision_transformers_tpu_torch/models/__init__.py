from . import halo  # noqa: F401  (registers arch type "halo_transformer")
from . import swin  # noqa: F401  (registers arch type "swin_transformer")
from . import vit  # noqa: F401  (registers arch type "vit")
