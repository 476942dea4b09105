"""Quantized delta-digest subsystem — the metro -> region control plane.
The port of ``repro/core/digest.py``, host-side numpy as there.

Each cluster advertises its top-M hottest entry keys as a *digest*; the
region keeps a replica per cluster that the federation's remote rung probes
(one grouped dispatch for the whole step's miss batch).  This module owns
the wire format and the shipped-bytes accounting of that control plane:

* **Quantization** (``DigestConfig.quant``): ``"fp32"`` ships raw keys
  (``D * 4`` bytes/row); ``"int8"`` ships symmetric per-row int8 codes plus
  one fp32 scale (``D + 4`` bytes/row, ~3.9x smaller at D=128).  The region
  probes the quantized codes directly (``federated_digest_lookup_quantized``
  dequantizes once per call — same kernel surface as the fp32 probe).  Because every digest candidate still passes the
  authoritative confirm against the owning cluster's full-precision shards,
  quantization error can only UNDER-report (a near-threshold entry's
  quantized score dips below tau -> recoverable miss); it can never serve a
  phantom payload, and with fresh digests the int8 hit set is a subset of
  the fp32 hit set (see tests/test_digest.py + the hypothesis variants).

* **Push-on-delta refresh** (``DigestConfig.refresh``): ``"full"`` ships
  all M rows every refresh; ``"delta"`` ships only rows whose *shipped
  representation* (quantized codes, scale, validity) changed since the last
  publish, each prefixed by a 4-byte row index — and falls back to the
  full-frame encoding whenever the delta would be larger (e.g. a cold
  start or full-churn refresh, where per-row indices are pure overhead),
  so a delta refresh NEVER ships more than a full one.  Delta application
  is exact reconstruction: after any interleaving of updates the region
  replica is bit-identical to a full refresh of the current digest
  (property-tested), so delta mode changes bytes, never semantics.

``RegionDigestBoard.bytes_shipped`` accumulates the metro -> region traffic;
``TwoTierRouter.digest_ship_ms`` prices it on the region link
(``NetworkModel.e_r``) for the benchmarks' latency accounting.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry

DIGEST_QUANTS = ("fp32", "int8")
DIGEST_REFRESHES = ("full", "delta")


@dataclasses.dataclass(frozen=True)
class DigestConfig:
    size: int = 128                  # top-M rows per cluster
    quant: str = "fp32"              # fp32 | int8 (wire + probe format)
    refresh: str = "full"            # full | delta (what a refresh ships)

    def __post_init__(self):
        assert self.size >= 1, self.size
        assert self.quant in DIGEST_QUANTS, self.quant
        assert self.refresh in DIGEST_REFRESHES, self.refresh

    @property
    def mode(self) -> str:
        return f"{self.refresh}_{self.quant}"

    def row_bytes(self, key_dim: int) -> int:
        """Wire bytes of one digest row's key payload."""
        if self.quant == "int8":
            return key_dim + 4           # int8 codes + fp32 scale
        return key_dim * 4


def quantize_rows(keys: np.ndarray):
    """Symmetric per-row int8 quantization: codes = round(key / scale),
    scale = max|row| / 127 (zero rows get scale 0 and all-zero codes).
    Returns (codes (M, D) int8, scales (M,) f32)."""
    keys = np.asarray(keys, np.float32)
    amax = np.abs(keys).max(axis=-1)
    scales = (amax / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    codes = np.clip(np.rint(keys / safe[:, None]), -127, 127).astype(np.int8)
    codes[scales == 0] = 0
    return codes, scales


def dequantize_rows(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return codes.astype(np.float32) * np.asarray(scales,
                                                 np.float32)[:, None]


class DigestUpdate(NamedTuple):
    """One refresh message: the changed rows (all M in full mode) and the
    wire size it cost on the metro -> region link."""

    rows: np.ndarray             # (R,) int32 digest row indices
    codes: np.ndarray            # (R, D) int8 (int8 mode) — else empty
    scales: np.ndarray           # (R,) f32 (int8 mode) — else empty
    keys: np.ndarray             # (R, D) f32 (fp32 mode) — else empty
    valid: np.ndarray            # (R,) bool
    bytes: int
    # IVF list assignment (ANN mode): the publisher's nearest-centroid
    # choice per shipped row, -1 when no codebook is attached.  Rides the
    # delta (+2 bytes/row, an int16 list id on the wire).
    list_ids: np.ndarray = np.zeros((0,), np.int32)


class DigestPublisher:
    """Metro side of one cluster's digest: remembers the last-shipped
    representation and emits full or delta ``DigestUpdate``s."""

    def __init__(self, cfg: DigestConfig, key_dim: int):
        self.cfg = cfg
        M, D = cfg.size, key_dim
        self._codes = np.zeros((M, D), np.int8)      # int8 mode
        self._scales = np.zeros((M,), np.float32)
        self._keys = np.zeros((M, D), np.float32)    # fp32 mode
        self._valid = np.zeros((M,), bool)
        self._codebook: Optional["PQCodebook"] = None

    def attach_codebook(self, codebook: "PQCodebook") -> None:
        """Adopt the region's shared ANN codebook: every later publish also
        ships each changed row's nearest-centroid IVF list id (+2 bytes/row
        on the wire), so the board can maintain its packed index without
        re-running coarse assignment for unchanged rows."""
        self._codebook = codebook

    def train_codebook(self, keys: np.ndarray, valid: np.ndarray,
                       ann: "AnnConfig") -> "PQCodebook":
        """Publisher-side codebook training on this cluster's own digest
        rows (deterministic under ``ann.seed``); the federation registers
        the result region-wide so every publisher encodes against the same
        centroids."""
        keys = np.asarray(keys, np.float32)[np.asarray(valid, bool)]
        return train_pq_codebook(keys, n_lists=ann.n_lists,
                                 n_sub=ann.n_sub, seed=ann.seed,
                                 iters=ann.train_iters)

    def reset(self) -> None:
        """Forget the last-shipped representation (cluster crash/revive:
        the region tombstoned our replica, so our delta memory lies — an
        unchanged row would otherwise never re-ship and the replica would
        stay empty forever).  The next ``publish`` ships a full frame,
        reconstructing the board bit-identically to a fresh publisher."""
        self._codes[:] = 0
        self._scales[:] = 0.0
        self._keys[:] = 0.0
        self._valid[:] = False

    def publish(self, keys: np.ndarray, valid: np.ndarray) -> DigestUpdate:
        """keys (M, D) f32 / valid (M,): the cluster's freshly-selected
        digest rows.  Returns the update to ship region-side."""
        cfg = self.cfg
        keys = np.asarray(keys, np.float32)
        valid = np.asarray(valid, bool)
        M, D = keys.shape
        keys = np.where(valid[:, None], keys, 0.0).astype(np.float32)
        if cfg.quant == "int8":
            codes, scales = quantize_rows(keys)
            codes[~valid] = 0
            scales[~valid] = 0.0
            changed = ((codes != self._codes).any(axis=1)
                       | (scales != self._scales) | (valid != self._valid))
        else:
            codes = np.zeros((0, D), np.int8)
            scales = np.zeros((0,), np.float32)
            changed = ((keys != self._keys).any(axis=1)
                       | (valid != self._valid))

        # full-frame encoding: every row's key payload + a valid bitmap
        full_bytes = M * cfg.row_bytes(D) + (M + 7) // 8
        if cfg.refresh == "full":
            rows = np.arange(M, dtype=np.int32)
            n_bytes = full_bytes
        else:
            rows = np.nonzero(changed)[0].astype(np.int32)
            # per changed row: 4-byte index + key payload (tombstones —
            # rows going invalid — ship the index only)
            n_live = int(valid[rows].sum())
            n_bytes = len(rows) * 4 + n_live * cfg.row_bytes(D)
            if n_bytes >= full_bytes:
                # high-churn refresh: the per-row indices are pure
                # overhead — ship the full frame instead, so delta never
                # costs more than full
                rows = np.arange(M, dtype=np.int32)
                n_bytes = full_bytes

        if self._codebook is not None:
            ids = assign_lists(self._codebook, keys).astype(np.int32)
            ids[~valid] = -1
            list_ids = ids[rows]
            n_bytes += 2 * int(valid[rows].sum())    # int16 list id / live row
        else:
            list_ids = np.full(len(rows), -1, np.int32)

        if cfg.quant == "int8":
            self._codes, self._scales = codes, scales
            update = DigestUpdate(rows, codes[rows], scales[rows],
                                  np.zeros((0, D), np.float32), valid[rows],
                                  n_bytes, list_ids)
        else:
            update = DigestUpdate(rows, codes, scales, keys[rows],
                                  valid[rows], n_bytes, list_ids)
        self._keys = keys
        self._valid = valid.copy()
        return update


class RegionDigestBoard:
    """Region side: K per-cluster digest replicas reconstructed from
    updates, exposed as the tensors the grouped digest probe scans, plus
    the shipped-bytes ledger of the metro -> region link."""

    def __init__(self, cfg: DigestConfig, num_clusters: int, key_dim: int,
                 metrics: Optional[MetricsRegistry] = None,
                 prefix: str = "digest"):
        self.cfg = cfg
        K, M, D = num_clusters, cfg.size, key_dim
        self.codes = np.zeros((K, M, D), np.int8)
        self.scales = np.zeros((K, M), np.float32)
        self.keys = np.zeros((K, M, D), np.float32)
        self.valid = np.zeros((K, M), bool)
        # ANN sidecar: shipped IVF list assignment per row (-1 = unassigned)
        # and the lazily-(re)built packed index over the board's live rows
        self.list_id = np.full((K, M), -1, np.int32)
        self._ann_codebook: Optional["PQCodebook"] = None
        self._ann_index: Optional["IVFPQIndex"] = None
        self._ann_dirty = True
        # the shipped-bytes ledger lives in the metrics registry (a private
        # one when the caller plumbs none); the legacy attribute names are
        # read-only views
        m = metrics if metrics is not None else MetricsRegistry()
        self._bytes_shipped = m.counter(f"{prefix}/bytes_shipped")
        self._rows_shipped = m.counter(f"{prefix}/rows_shipped")
        self._updates_applied = m.counter(f"{prefix}/updates_applied")
        self._tombstones = m.counter(f"{prefix}/tombstones")

    @property
    def bytes_shipped(self) -> int:
        return self._bytes_shipped.value

    @property
    def rows_shipped(self) -> int:
        return self._rows_shipped.value

    @property
    def updates_applied(self) -> int:
        return self._updates_applied.value

    # ------------------------------------------------------------------
    def apply(self, cluster: int, update: DigestUpdate) -> None:
        rows = update.rows
        if self.cfg.quant == "int8":
            self.codes[cluster, rows] = update.codes
            self.scales[cluster, rows] = update.scales
        else:
            self.keys[cluster, rows] = update.keys
        self.valid[cluster, rows] = update.valid
        if len(update.list_ids):
            self.list_id[cluster, rows] = update.list_ids
        self._bytes_shipped.inc(update.bytes)
        self._rows_shipped.inc(len(rows))
        self._updates_applied.inc()
        if len(rows):
            self._ann_dirty = True

    # ------------------------------------------------------------------
    def tombstone(self, cluster: int) -> None:
        """Invalidate one cluster's whole replica (membership declared it
        dead).  Tombstoned rows stop attracting digest probes immediately;
        the row payloads are zeroed too so a revived cluster's first full
        publish reconstructs the replica bit-identically to a cold board
        (no stale codes left behind under rows the new digest skips)."""
        self.codes[cluster] = 0
        self.scales[cluster] = 0.0
        self.keys[cluster] = 0.0
        self.valid[cluster] = False
        self.list_id[cluster] = -1
        self._ann_dirty = True
        self._tombstones.inc()

    @property
    def tombstones(self) -> int:
        return self._tombstones.value

    # ------------------------------------------------------------------
    def probe_keys(self) -> np.ndarray:
        """(K, M, D) f32 digest matrix as the probe sees it (dequantized in
        int8 mode — the device path dequantizes once per probe call;
        this host-side view exists for oracles/tests)."""
        if self.cfg.quant == "int8":
            K, M, D = self.codes.shape
            return (self.codes.astype(np.float32)
                    * self.scales[..., None]).reshape(K, M, D)
        return self.keys

    # ------------------------------------------------------------------
    @property
    def ann_codebook(self) -> Optional["PQCodebook"]:
        return self._ann_codebook

    def adopt_codebook(self, codebook: "PQCodebook") -> None:
        """Register the region-wide shared ANN codebook (trained by one
        publisher) and charge its one-time ship onto the byte ledger."""
        self._ann_codebook = codebook
        self._bytes_shipped.inc(codebook_bytes(codebook))
        self._ann_dirty = True

    def ann_index(self, ann: "AnnConfig") -> Optional["IVFPQIndex"]:
        """The packed IVF-PQ index over the board's live rows, rebuilt
        lazily after any apply/tombstone.  Rebuilds honor the shipped list
        assignments (rows without one — shipped before the codebook
        existed — are assigned board-side) and drop tombstoned rows, so a
        dead cluster's keys stop attracting ANN candidates the moment its
        replica is tombstoned."""
        if self._ann_codebook is None:
            return None
        if self._ann_dirty or self._ann_index is None:
            K, M, D = self.keys.shape
            owner = np.repeat(np.arange(K, dtype=np.int32), M)
            self._ann_index = build_ivfpq_index(
                self._ann_codebook, self.probe_keys().reshape(K * M, D),
                self.valid.reshape(-1), owner,
                list_ids=self.list_id.reshape(-1), cap_slack=ann.cap_slack)
            self._ann_dirty = False
        return self._ann_index

    def stats(self) -> dict:
        return {
            "mode": self.cfg.mode,
            "size": self.cfg.size,
            "bytes_shipped": int(self.bytes_shipped),
            "rows_shipped": int(self.rows_shipped),
            "updates_applied": int(self.updates_applied),
            "tombstones": int(self.tombstones),
            "ann_rows": (0 if self._ann_index is None
                         else int(self._ann_index.slot_valid.sum())),
        }


# ---------------------------------------------------------------------------
# Two-stage IVF-PQ ANN index — the board-scale probe structure
#
# Brute probes read ``row_bytes(D)`` per advertised row (D + 4 for int8),
# which stops paying once a region board advertises millions of keys.  The
# ANN sidecar quantizes each row to ``n_sub`` one-byte codes against a
# SHARED residual codebook (beating per-row int8 scales at large D, as the
# module docstring promised) behind a coarse centroid stage, and
# ``kernels/ivf_pq`` scans both stages in ONE kernel launch.  Recall loss
# can only UNDER-report — every candidate still passes the authoritative
# confirm — the same safety contract as int8 quantization above.
# ---------------------------------------------------------------------------

ANN_MODES = ("off", "auto", "ivfpq")


@dataclasses.dataclass(frozen=True)
class AnnConfig:
    """Knobs for the board's IVF-PQ sidecar.

    ``mode="auto"`` keeps the brute int8/fp32 probe while the board is
    small (scanning a few thousand rows is one cheap matmul) and switches
    the remote rung to the ANN kernel once the board advertises
    ``min_rows``+ live rows; ``"ivfpq"`` forces the ANN path; ``"off"``
    never builds the index."""

    mode: str = "auto"               # off | auto | ivfpq
    min_rows: int = 4096             # auto: brute below, IVF-PQ at/above
    n_lists: int = 64                # coarse centroids / inverted lists
    n_sub: int = 8                   # PQ subspaces (bytes per row)
    n_probe: int = 8                 # lists scanned per query
    seed: int = 0                    # k-means seed (training determinism)
    train_iters: int = 8
    cap_slack: float = 1.5           # list capacity vs mean occupancy

    def __post_init__(self):
        assert self.mode in ANN_MODES, self.mode
        assert 1 <= self.n_probe <= self.n_lists, (self.n_probe,
                                                   self.n_lists)
        assert self.n_sub >= 1 and self.cap_slack >= 1.0


class PQCodebook(NamedTuple):
    """The shared two-stage quantizer: coarse centroids (one per inverted
    list) + a 256-entry residual codebook per subspace."""

    centroids: np.ndarray            # (L, D) f32
    codebook: np.ndarray             # (S, 256, D // S) f32
    seed: int


def codebook_bytes(cb: PQCodebook) -> int:
    """One-time wire cost of shipping the shared quantizer region-wide."""
    return int(cb.centroids.size * 4 + cb.codebook.size * 4)


def _nearest_chunked(x: np.ndarray, cent: np.ndarray, tries: int = 1,
                     chunk: int = 8192) -> np.ndarray:
    """Per row of ``x``: the ``tries`` nearest rows of ``cent`` by L2,
    ascending.  Chunked so 1M-row boards never materialize (R, L) at f64."""
    x = np.asarray(x, np.float32)
    cent = np.asarray(cent, np.float32)
    tries = min(tries, cent.shape[0])
    c2 = (cent * cent).sum(axis=1)
    out = np.empty((x.shape[0], tries), np.int64)
    for i in range(0, x.shape[0], chunk):
        d = c2[None, :] - 2.0 * (x[i:i + chunk] @ cent.T)
        if tries >= d.shape[1]:
            part = np.argsort(d, axis=1)[:, :tries]
        else:
            part = np.argpartition(d, tries - 1, axis=1)[:, :tries]
            rows = np.arange(d.shape[0])[:, None]
            part = part[rows, np.argsort(d[rows, part], axis=1)]
        out[i:i + chunk] = part
    return out


def _kmeans(x: np.ndarray, k: int, rng: np.random.Generator,
            iters: int) -> np.ndarray:
    """Deterministic seeded k-means (empty clusters keep their previous
    center, so the result is a pure function of (x, seed, iters))."""
    x = np.asarray(x, np.float32)
    n = max(1, x.shape[0])
    if x.shape[0] == 0:
        return np.zeros((k, x.shape[1]), np.float32)
    init = rng.choice(n, size=k, replace=n < k)
    cent = x[init].copy()
    for _ in range(iters):
        a = _nearest_chunked(x, cent)[:, 0]
        sums = np.zeros_like(cent, dtype=np.float64)
        np.add.at(sums, a, x.astype(np.float64))
        counts = np.bincount(a, minlength=k)
        nz = counts > 0
        cent[nz] = (sums[nz] / counts[nz, None]).astype(np.float32)
    return cent


def train_pq_codebook(keys: np.ndarray, *, n_lists: int, n_sub: int,
                      seed: int = 0, iters: int = 8,
                      max_train: int = 65536) -> PQCodebook:
    """Train the shared quantizer on a cluster's digest rows: coarse
    k-means over the keys, then 256-entry k-means per subspace of the
    residuals.  Deterministic under a fixed seed (property-tested); large
    training sets are subsampled deterministically."""
    keys = np.asarray(keys, np.float32)
    n, D = keys.shape
    assert D % n_sub == 0, (D, n_sub)
    rng = np.random.default_rng(seed)
    if n > max_train:
        keys = keys[rng.choice(n, size=max_train, replace=False)]
    centroids = _kmeans(keys, n_lists, rng, iters)
    if len(keys):
        resid = keys - centroids[_nearest_chunked(keys, centroids)[:, 0]]
    else:
        resid = keys
    dsub = D // n_sub
    cb = np.zeros((n_sub, 256, dsub), np.float32)
    for s in range(n_sub):
        cb[s] = _kmeans(resid[:, s * dsub:(s + 1) * dsub], 256, rng, iters)
    return PQCodebook(centroids, cb, seed)


def assign_lists(cb: PQCodebook, keys: np.ndarray) -> np.ndarray:
    """(n,) int32 nearest-centroid list id per key — the assignment a
    publisher ships with its delta refreshes."""
    return _nearest_chunked(keys, cb.centroids)[:, 0].astype(np.int32)


def encode_pq(cb: PQCodebook, residuals: np.ndarray) -> np.ndarray:
    """(n, S) uint8 per-subspace codes of residual vectors."""
    n, D = residuals.shape
    S = cb.codebook.shape[0]
    dsub = D // S
    codes = np.empty((n, S), np.uint8)
    for s in range(S):
        codes[:, s] = _nearest_chunked(
            residuals[:, s * dsub:(s + 1) * dsub], cb.codebook[s])[:, 0]
    return codes


class IVFPQIndex(NamedTuple):
    """The packed probe structure ``kernels/ivf_pq`` scans: board rows
    bucketed into inverted lists of ``list_cap`` slots.  ``slot_rid`` maps
    a flat kernel candidate (``list * cap + slot``) back to its global
    digest row id (cluster * M + row); ``dropped`` counts live rows that
    found no slot within their ``spill_tries`` nearest lists — dropping is
    safe (under-report-only), but it is tracked so benchmarks can see it."""

    centroids: np.ndarray            # (L, D) f32
    cent_valid: np.ndarray           # (L,) bool
    codes: np.ndarray                # (L, cap, S) uint8
    slot_valid: np.ndarray           # (L, cap) bool
    slot_owner: np.ndarray           # (L, cap) int32, -1 = empty
    slot_rid: np.ndarray             # (L, cap) int32, -1 = empty
    codebook: np.ndarray             # (S, 256, D // S) f32
    dropped: int

    @property
    def list_cap(self) -> int:
        return self.codes.shape[1]


def build_ivfpq_index(cb: PQCodebook, keys: np.ndarray, valid: np.ndarray,
                      owner: np.ndarray, *, rid: Optional[np.ndarray] = None,
                      list_ids: Optional[np.ndarray] = None,
                      cap: Optional[int] = None, cap_slack: float = 1.5,
                      spill_tries: int = 3) -> IVFPQIndex:
    """Pack live board rows into the IVF-PQ probe structure.

    Rows go to their shipped list assignment when one exists (else nearest
    centroid); a full list spills its overflow to the row's next-nearest
    lists (still findable whenever those lists are probed, so spilling
    only moves recall, never correctness), and rows that exhaust
    ``spill_tries`` are dropped — under-report-only, counted in
    ``dropped``.  Tombstoned rows (``valid`` False) are simply never
    packed.  PQ codes are encoded against the centroid of the list a row
    actually landed in."""
    keys = np.asarray(keys, np.float32)
    valid = np.asarray(valid, bool)
    owner = np.asarray(owner, np.int32)
    R, D = keys.shape
    rid = (np.arange(R, dtype=np.int32) if rid is None
           else np.asarray(rid, np.int32))
    L = cb.centroids.shape[0]
    S = cb.codebook.shape[0]
    live = np.nonzero(valid)[0]
    nlive = len(live)
    if cap is None:
        cap = int(np.ceil(cap_slack * max(1.0, nlive / L)))
        cap = max(8, -(-cap // 8) * 8)

    order = _nearest_chunked(keys[live], cb.centroids,
                             tries=min(spill_tries, L))
    first = order[:, 0].copy()
    if list_ids is not None:
        shipped = np.asarray(list_ids)[live]
        use = (shipped >= 0) & (shipped < L)
        first[use] = shipped[use]
    choices = np.concatenate([first[:, None], order], axis=1)
    # attempt 0 is the (possibly shipped) first choice; mask the duplicate
    # in the nearest-order columns so no attempt retries a rejected list
    choices[:, 1:][choices[:, 1:] == first[:, None]] = -1

    fill = np.zeros(L, np.int64)
    placed_list = np.full(nlive, -1, np.int64)
    placed_slot = np.full(nlive, -1, np.int64)
    remaining = np.arange(nlive)
    for t in range(choices.shape[1]):
        if not len(remaining):
            break
        cand = choices[remaining, t]
        ok_cand = cand >= 0
        perm = np.argsort(np.where(ok_cand, cand, L), kind="stable")
        cl = cand[perm]
        in_play = cl >= 0
        cl_ip = cl[in_play]
        starts = np.searchsorted(cl_ip, np.arange(L))
        pos = np.arange(len(cl_ip)) - starts[cl_ip]
        slot = fill[cl_ip] + pos
        fits = slot < cap
        sel = perm[in_play][fits]
        placed_list[remaining[sel]] = cl_ip[fits]
        placed_slot[remaining[sel]] = slot[fits]
        fill += np.bincount(cl_ip[fits], minlength=L)
        rejected = np.concatenate([perm[in_play][~fits], perm[~in_play]])
        remaining = remaining[np.sort(rejected)]

    dropped = int(len(remaining))
    codes = np.zeros((L, cap, S), np.uint8)
    slot_valid = np.zeros((L, cap), bool)
    slot_owner = np.full((L, cap), -1, np.int32)
    slot_rid = np.full((L, cap), -1, np.int32)
    got = placed_list >= 0
    li = placed_list[got]
    sl = placed_slot[got]
    rows = live[got]
    if len(rows):
        resid = keys[rows] - cb.centroids[li]
        codes[li, sl] = encode_pq(cb, resid)
        slot_valid[li, sl] = True
        slot_owner[li, sl] = owner[rows]
        slot_rid[li, sl] = rid[rows]
    return IVFPQIndex(cb.centroids.astype(np.float32), fill > 0, codes,
                      slot_valid, slot_owner, slot_rid,
                      cb.codebook.astype(np.float32), dropped)


def region_pin_mask(shard_keys: np.ndarray, shard_valid: np.ndarray,
                    peer_served: np.ndarray,
                    protected_keys: Optional[np.ndarray],
                    threshold: float, hot_min: int = 1) -> np.ndarray:
    """Region-aware eviction support: which of a shard's entries are the
    region's last PROTECTED copy of a region-hot entry.

    An entry is region-hot when it has served ``hot_min``+ requests for
    other nodes/clusters (``peer_served``, maintained by
    ``SemanticCache.touch``); it pins unless ``protected_keys`` already
    holds an above-threshold duplicate.  The federation walks clusters in
    id order and passes the keys ALREADY PINNED at earlier shards/
    clusters as ``protected_keys`` — deferring only to genuinely
    protected copies (never to a cold, unpinned replica) guarantees the
    lowest-id region-hot holder of every entry keeps a pin.  Pinned
    entries are lifted above all unpinned ones in eviction priority
    (``EvictionPolicy(region_aware=True)``), so a region-hot entry cannot
    vanish from every cluster at once just because its authoritative
    holder saw local churn.
    """
    shard_keys = np.asarray(shard_keys, np.float32)
    hot = np.asarray(shard_valid, bool) & (np.asarray(peer_served) >= hot_min)
    if not hot.any():
        return np.zeros(shard_keys.shape[0], bool)
    if protected_keys is None or not len(protected_keys):
        return hot                       # nothing protected anywhere yet
    dup = (shard_keys @ np.asarray(protected_keys, np.float32).T
           ).max(axis=1) >= threshold
    return hot & ~dup
