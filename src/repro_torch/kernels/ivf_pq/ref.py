"""Plain PyTorch version of the two-stage IVF-PQ digest probe.

Mirrors ``repro/kernels/ivf_pq/ref.py`` (index layout documented there):
stage 1 scores every query against every centroid and keeps the top
``n_probe`` lists; stage 2 reconstructs each probed list's keys as
``centroid + decode(codes)`` and takes the masked top-k over the flat
``list * cap + slot`` axis.  Top-k order is ``lax.top_k``'s — descending,
ties to the lower index — from a stable descending sort.

Two departures in how, not what:

* The decode is a gather, ``codebook[s][codes[..., s]]``: the reference's
  one-hot matmul copies the same entries exactly on the CPU, but a card
  running it in TF32 would round them.
* The reference decodes every slot at once, an (L * cap, D) tensor (8 GiB
  at 1M slots and D = 2048).  Here lists are decoded and scored in chunks
  of at most ``CHUNK_BYTES`` of keys, and each chunk's top-k merges into
  the running one.  The (score desc, index asc) order is total, so the
  merge gives exactly the single top-k over the whole row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.similarity.ref import _topk_desc

NEG_INF = -1e30
CHUNK_BYTES = 256 * 2 ** 20        # decoded keys held at once


def decode_pq_codes(codebook: torch.Tensor, codes: torch.Tensor
                    ) -> torch.Tensor:
    """codes (..., S) uint8 -> residual vectors (..., D) f32: subspace ``s``
    of row r is ``codebook[s][codes[r, s]]``."""
    cb = codebook.float()
    return torch.cat([cb[s][codes[..., s].long()]
                      for s in range(cb.shape[0])], dim=-1)


def ivf_pq_probe_ref(queries: torch.Tensor, home: torch.Tensor,
                     centroids: torch.Tensor, cent_valid: torch.Tensor,
                     codes: torch.Tensor, slot_valid: torch.Tensor,
                     slot_owner: torch.Tensor, codebook: torch.Tensor, *,
                     k: int, n_probe: int):
    """queries (Q, D); home (Q,) owning-cluster id per query (its own rows
    are excluded).  Returns (idx (Q, k) int32 flat slot ids, score (Q, k)
    f32, sel (Q, n_probe) int32 probed list ids), scores descending, ties
    toward the lower flat index."""
    L, cap, S = codes.shape
    Q, D = queries.shape
    q = queries.float()
    cent = centroids.float()
    coarse = q @ cent.T                                      # (Q, L)
    coarse = torch.where(cent_valid.bool()[None, :], coarse, NEG_INF)
    _, sel = _topk_desc(coarse, n_probe)                     # (Q, n_probe)
    selmask = torch.zeros((Q, L), dtype=torch.bool, device=q.device)
    selmask.scatter_(1, sel.long(), True)
    home = home.to(torch.int32)[:, None]

    per_list = cap * D * 4
    step = max(1, CHUNK_BYTES // per_list)
    best_s = best_i = None
    for l0 in range(0, L, step):
        l1 = min(L, l0 + step)
        keys = decode_pq_codes(codebook, codes[l0:l1])       # (n, cap, D)
        keys += cent[l0:l1, None, :]
        scores = q @ keys.reshape(-1, D).T                   # (Q, n * cap)
        del keys
        ok = (slot_valid[l0:l1].reshape(-1).bool()[None, :]
              & (slot_owner[l0:l1].reshape(-1).to(torch.int32)[None, :]
                 != home)
              & selmask[:, l0:l1].repeat_interleave(cap, dim=1))
        scores = torch.where(ok, scores, NEG_INF)
        s, i = _topk_desc(scores, min(k, scores.shape[1]))
        i = i + l0 * cap
        if best_s is not None:
            # earlier chunks hold lower flat indices: a stable sort keeps
            # them ahead on equal scores
            s = torch.cat([best_s, s], dim=1)
            i = torch.cat([best_i, i], dim=1)
            s, pos = _topk_desc(s, min(k, s.shape[1]))
            i = torch.gather(i, 1, pos.long())
        best_s, best_i = s, i
    return best_i.to(torch.int32), best_s, sel
