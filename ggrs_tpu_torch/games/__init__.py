from .boxgame import (
    BOX_INPUT_DOWN,
    BOX_INPUT_LEFT,
    BOX_INPUT_RIGHT,
    BOX_INPUT_UP,
    BoxGame,
    boxgame_config,
)
from .chipvm import ChipVM
from .ecs_world import EcsWorld
from .rtscmd import RtsCmd, RtsCmdGame, decode_commands, encode_commands
from .vectorwar import VectorWar

__all__ = [
    "BOX_INPUT_UP",
    "BOX_INPUT_DOWN",
    "BOX_INPUT_LEFT",
    "BOX_INPUT_RIGHT",
    "BoxGame",
    "ChipVM",
    "EcsWorld",
    "RtsCmd",
    "RtsCmdGame",
    "VectorWar",
    "boxgame_config",
    "decode_commands",
    "encode_commands",
]
