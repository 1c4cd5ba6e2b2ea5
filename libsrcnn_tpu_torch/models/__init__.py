"""Model zoo: SRCNN 9-1-5 (the reference's, and its int8 pack), the HR
families vdsr and srcnn955, and the LR families fsrcnn and espcn."""

from . import espcn, fsrcnn, srcnn, srcnn_generic, srcnn_int8, vdsr  # noqa: F401
from .srcnn import SRCNN915  # noqa: F401
from .srcnn_generic import SRCNNGeneric  # noqa: F401
