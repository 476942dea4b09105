from repro_torch.kernels.paged_latent.ops import paged_latent
from repro_torch.kernels.paged_latent.ref import paged_latent_ref
