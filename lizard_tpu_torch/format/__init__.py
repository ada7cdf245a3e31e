from lizard_tpu_torch.format.constants import *  # noqa: F401,F403
from lizard_tpu_torch.format.levels import LEVELS, LevelParams, Parser, Codewords  # noqa: F401
