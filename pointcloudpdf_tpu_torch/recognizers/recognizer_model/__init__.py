from .pt_v1 import PTRecognizer
from .st_v1m1 import STRecognizer
