# Workload generators (numpy only), the port's copy of repro/data/workload.py.
from repro_torch.data.workload import (ChaosEvent, ChaosSchedule,
                                       FramePacedWorkload, FrameRequest,
                                       RoamingWorkload, SharedPrefixWorkload,
                                       ZipfWorkload)
