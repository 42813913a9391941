from .boxgame import (
    BOX_INPUT_DOWN,
    BOX_INPUT_LEFT,
    BOX_INPUT_RIGHT,
    BOX_INPUT_UP,
    BoxGame,
    boxgame_config,
)
from .chipvm import ChipVM

__all__ = [
    "BOX_INPUT_UP",
    "BOX_INPUT_DOWN",
    "BOX_INPUT_LEFT",
    "BOX_INPUT_RIGHT",
    "BoxGame",
    "ChipVM",
    "boxgame_config",
]
