# Workload generators and the synthetic training data (numpy only), the
# port's copies of repro/data/workload.py and repro/data/pipeline.py.
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.data.workload import (ChaosEvent, ChaosSchedule,
                                       FramePacedWorkload, FrameRequest,
                                       RoamingWorkload, SharedPrefixWorkload,
                                       ZipfWorkload)
