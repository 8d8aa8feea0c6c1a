"""The port's chip AIRs, by name (the names are the reference's)."""

from .sha256 import Sha256Air

#: AIR class by chip name
AIRS = {Sha256Air.name: Sha256Air}
