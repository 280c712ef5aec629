from .point_group import PointGroup
