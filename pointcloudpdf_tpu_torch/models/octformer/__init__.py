from .octformer import OctFormer
