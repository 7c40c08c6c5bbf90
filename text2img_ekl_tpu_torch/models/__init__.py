"""Generator and discriminator assemblies."""
from .discriminator import build_discriminators  # noqa: F401
from .generator import build_generator  # noqa: F401
