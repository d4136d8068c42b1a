from repro_torch.core.registry import available_systems, register_system  # noqa: F401
from repro_torch.sim.engine import Sim  # noqa: F401
from repro_torch.sim.systems import (  # noqa: F401
    EmulationContext, SystemResult, WorkloadResult, run_system,
)
from repro_torch.sim.traces import (  # noqa: F401
    montage_like, nasa_ipsc_like, sdsc_blue_like, standard_workloads,
)
