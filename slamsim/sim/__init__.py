"""Scene configurations and lax.scan simulation drivers.

Scene configs live with their consumers (EkfConfig / PfConfig /
SlamSceneConfig hold the reference demo constants, SURVEY.md section 5
"config system"); this package re-exports them alongside the generic
drivers so scenario code has a single import point.
"""

from slamsim.filters.ekf import EkfConfig
from slamsim.filters.pf import PfConfig
from slamsim.sim.driver import rollout, rollout_batch
from slamsim.slam.frontend import SlamSceneConfig

__all__ = ["EkfConfig", "PfConfig", "SlamSceneConfig", "rollout",
           "rollout_batch"]
