from repro_torch.kernels.paged_attention.ops import (
    attention_kv_bytes_per_step, paged_attention)
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_gather_view)
