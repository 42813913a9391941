from .boxgame import BoxGame
from .chipvm import ChipVM

__all__ = ["BoxGame", "ChipVM"]
