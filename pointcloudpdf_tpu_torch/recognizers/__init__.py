from .builder import RECOGNIZER, build_recognizer
from .max_probability import MaxProbability
from .pointpdf import PointPdfV1
from . import recognizer_model  # registers PointTransformer-Recognizer
