from .geometry import Geometry, coord_select  # noqa: F401
