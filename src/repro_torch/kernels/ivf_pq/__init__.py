from repro_torch.kernels.ivf_pq.ops import ivf_pq_probe
from repro_torch.kernels.ivf_pq.ref import decode_pq_codes, ivf_pq_probe_ref
