from .charcnn import CharCNN
from .lstm import SeqLSTM

__all__ = ["CharCNN", "SeqLSTM"]
