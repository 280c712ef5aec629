from .cac import CACSegmentor
