from .qa import *  # noqa: F401,F403
from . import reports  # noqa: F401
