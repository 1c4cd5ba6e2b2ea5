"""Model zoo; the port has the SRCNN 9-1-5 so far (ROADMAP M9 ports the rest)."""

from . import srcnn  # noqa: F401
from .srcnn import SRCNN915  # noqa: F401
