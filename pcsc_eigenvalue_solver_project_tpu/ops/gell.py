"""Packed gather-ELL ("GELL") SpMV for unstructured sparse operators.

The reference's hot op ``A * x`` for an arbitrary ``Eigen::SparseMatrix``
(reference src/power_method/power_method.hpp:69 with the sparse arm
of src/matrix/matrix.hpp:39-44), evaluated in plain ``jax.numpy`` from a
pack built once on the host.

Layout ("GELL pack"):
- Rows are tiled ``tile_rows`` (= ``ng``*128) at a time. Within a tile,
  every nonzero (r, c, v) is bucketed by ``l = c % 128`` and packed
  densely into **slots** in sorted (output-row, column-segment) order.
- The segment word carries ``seg = c // 128`` plus suffix-scan mask bits.
  It is **int16** when the column count fits 13 bits of segment
  (n_cols <= 2**13 * 128 = 1,048,576; masks in bits 13/14/15) and int32
  otherwise (seg in the low 16 bits, masks at bits 16/17/18).
- Entries of the same output row in the same bucket are **contiguous slot
  runs**; a masked Hillis-Steele suffix scan (rolls by 1/2/4) sums each
  run into its head slot, handling up to 8 duplicates per (row, bucket).
  The number of scan steps executed is the static ``scan_steps`` =
  ceil(log2(longest run)) recorded at pack time (0 for collision-free
  packs).
- A per-output-row **inverse permutation** moves each head slot to its
  output position. It is stored as **int8** (bit 7 = valid, low 7 bits =
  head slot).
- Complex values are stored as split re/im planes ``(tiles, 2, 128, 128)``.
- Entries that overflow a bucket (slot >= 128) or a run (>= 8 deep) go to
  a small COO **spill** tail evaluated with gather + ``.at[].add``.

``GELLPack.with_values_dtype(jnp.bfloat16)`` halves the value bytes;
products accumulate in the vector's dtype.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

LANES = 128
DEFAULT_TILE_ROWS = 384          # ng = 3 output groups; good fill at ~33 nnz/row
_SEG16_BITS = 13                 # int16 word: 13-bit seg + 3 scan-mask bits
_SEG16_MAX_COLS = (1 << _SEG16_BITS) * LANES   # 1,048,576
_MAX_SEG = (1 << 16) - 1         # int32 word: seg must fit 16 bits


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GELLPack:
    """Device arrays of one packed gather-ELL operator (a pytree).

    ``seg_packed[t, l, slot]``: the segment word (int16 or int32 — see
    module docstring). ``val`` is (tiles, 128, 128) for real dtypes and
    (tiles, 2, 128, 128) re/im planes for complex. ``inv[t, g*128+l, j]``
    int8: bit 7 = valid, low 7 bits = head slot of output row
    ``t*tile_rows + g*128 + j``'s run in bucket ``l``. COO spill tail in
    ``sp_*`` (``sp_vals`` is (2, n_spill) planes when complex).
    """

    seg_packed: jax.Array   # (n_tiles, 128, 128) int16 | int32
    val: jax.Array          # (n_tiles, [2,] 128, 128)
    inv: jax.Array          # (n_tiles, ng*128, 128) int8
    sp_rows: jax.Array      # (n_spill,) int32
    sp_cols: jax.Array      # (n_spill,) int32
    sp_vals: jax.Array      # (n_spill,) | (2, n_spill)
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    tile_rows: int = dataclasses.field(metadata=dict(static=True))
    scan_steps: int = dataclasses.field(default=3, metadata=dict(static=True))
    is_complex: bool = dataclasses.field(default=False,
                                         metadata=dict(static=True))

    @property
    def n_tiles(self) -> int:
        return -(-self.shape[0] // self.tile_rows)

    @property
    def ng(self) -> int:
        return self.tile_rows // LANES

    @property
    def n_chunks(self) -> int:
        s = -(-self.shape[1] // LANES)
        return -(-s // LANES)

    @property
    def n_spill(self) -> int:
        return int(self.sp_rows.shape[0])

    @property
    def dtype(self):
        """The logical scalar dtype of the operator."""
        if self.is_complex:
            r = np.dtype(self.val.dtype)
            if r == np.dtype(jnp.bfloat16):
                return np.dtype(np.complex64)
            return np.dtype(np.complex64) if r == np.dtype(np.float32) \
                else np.dtype(np.complex128)
        return np.dtype(self.val.dtype)

    def with_values_dtype(self, dtype) -> "GELLPack":
        """Same pack with values (and spill) cast — e.g. jnp.bfloat16 to
        halve the value bytes."""
        return dataclasses.replace(self, val=self.val.astype(dtype),
                                   sp_vals=self.sp_vals.astype(dtype))


def auto_tile_rows(n_rows: int, nnz: int) -> int:
    """Pick tile_rows so the expected bucket fill is ~0.75 (96 slots):
    tile_rows * (nnz/n_rows) / 128 ~= 96, rounded to a multiple of 128."""
    avg = max(nnz / max(n_rows, 1), 1e-9)
    t = int(round(96.0 * LANES / avg / LANES)) * LANES
    return int(np.clip(t, LANES, 1024))


def pack_gell(row, col, values, shape, tile_rows: int | None = None) -> GELLPack:
    """Host-side packing of COO triplets (may contain duplicates — they
    become scan-run members and sum, matching SpMV semantics)."""
    n_rows, n_cols = map(int, shape)
    r = np.asarray(row, np.int64)
    c = np.asarray(col, np.int64)
    v = np.asarray(values)
    is_complex = np.dtype(v.dtype).kind == "c"
    nnz = len(r)
    if tile_rows is None:
        tile_rows = auto_tile_rows(n_rows, nnz)
    if tile_rows % LANES != 0:
        raise ValueError("pack_gell: tile_rows must be a multiple of 128")
    T = tile_rows
    ng = T // LANES
    n_tiles = max(-(-n_rows // T), 1)

    tile = r // T
    o = r % T                      # output row within tile
    l = c % LANES                  # bucket
    seg = c // LANES               # column segment (gather target)
    order = np.lexsort((seg, o, l, tile))
    t_, o_, l_, g_, v_ = tile[order], o[order], l[order], seg[order], v[order]
    r_, c_ = r[order], c[order]

    # run id over (tile, l, o) groups — members are consecutive after the sort
    key_g = (t_ * LANES + l_) * T + o_
    first_g = np.ones(nnz, bool)
    first_g[1:] = key_g[1:] != key_g[:-1]
    starts_g = np.flatnonzero(first_g)
    run_g = np.cumsum(first_g) - 1
    rank = np.arange(nnz) - starts_g[run_g] if nnz else np.zeros(0, np.int64)
    # slot within (tile, l): dense packing along the lane axis
    key_tl = t_ * LANES + l_
    first_tl = np.ones(nnz, bool)
    first_tl[1:] = key_tl[1:] != key_tl[:-1]
    starts_tl = np.flatnonzero(first_tl)
    run_tl = np.cumsum(first_tl) - 1
    slot = np.arange(nnz) - starts_tl[run_tl] if nnz else np.zeros(0, np.int64)

    spill = (slot >= LANES) | (rank >= 8)
    keep = ~spill
    kt, ko, kl, kg, kv, kslot = (t_[keep], o_[keep], l_[keep], g_[keep],
                                 v_[keep], slot[keep])
    # run rank/size on the KEPT set only: a spilled tail member must not
    # inflate the scan masks of kept members
    krun = run_g[keep]
    kfirst = np.ones(len(krun), bool)
    kfirst[1:] = krun[1:] != krun[:-1]
    kstarts = np.flatnonzero(kfirst)
    krid = np.cumsum(kfirst) - 1
    krank = np.arange(len(krun)) - kstarts[krid] if len(krun) else np.zeros(0, np.int64)
    kgsize = np.diff(np.append(kstarts, len(krun)))
    remaining = (kgsize[krid] - krank - 1) if len(krun) else np.zeros(0, np.int64)

    if n_cols > (_MAX_SEG + 1) * LANES:
        raise ValueError("pack_gell: n_cols too large for the 16-bit segment field")
    seg16 = n_cols <= _SEG16_MAX_COLS

    m1 = (remaining >= 1).astype(np.int32)
    m2 = (remaining >= 2).astype(np.int32)
    m4 = (remaining >= 4).astype(np.int32)
    max_rem = int(remaining.max()) if len(remaining) else 0
    scan_steps = 0 if max_rem < 1 else 1 if max_rem < 2 else \
        2 if max_rem < 4 else 3

    if seg16:
        packed = (kg.astype(np.int32) | (m1 << _SEG16_BITS)
                  | (m2 << (_SEG16_BITS + 1)) | (m4 << (_SEG16_BITS + 2)))
        seg_arr = np.zeros((n_tiles, LANES, LANES), np.uint16)
        seg_arr[kt, kl, kslot] = packed.astype(np.uint16)
        seg_arr = seg_arr.view(np.int16)
    else:
        packed = kg.astype(np.int32) | (m1 << 16) | (m2 << 17) | (m4 << 18)
        seg_arr = np.zeros((n_tiles, LANES, LANES), np.int32)
        seg_arr[kt, kl, kslot] = packed

    rdt = np.float64 if np.dtype(v.dtype).itemsize > (8 if is_complex else 4) \
        else np.float32
    if is_complex:
        val_arr = np.zeros((n_tiles, 2, LANES, LANES), rdt)
        val_arr[kt, 0, kl, kslot] = kv.real
        val_arr[kt, 1, kl, kslot] = kv.imag
        sp_vals = np.stack([v_[spill].real, v_[spill].imag]).astype(rdt)
    else:
        val_arr = np.zeros((n_tiles, LANES, LANES), v.dtype)
        val_arr[kt, kl, kslot] = kv
        sp_vals = v_[spill]

    inv_arr = np.zeros((n_tiles, ng, LANES, LANES), np.uint8)
    heads = krank == 0
    ht, hl, ho, hs = kt[heads], kl[heads], ko[heads], kslot[heads]
    inv_arr[ht, ho // LANES, hl, ho % LANES] = (hs | 0x80).astype(np.uint8)

    return GELLPack(
        seg_packed=jnp.asarray(seg_arr),
        val=jnp.asarray(val_arr),
        inv=jnp.asarray(inv_arr.reshape(n_tiles, ng * LANES, LANES)
                        .view(np.int8)),
        sp_rows=jnp.asarray(r_[spill], jnp.int32),
        sp_cols=jnp.asarray(c_[spill], jnp.int32),
        sp_vals=jnp.asarray(sp_vals),
        shape=(n_rows, n_cols),
        tile_rows=T,
        scan_steps=scan_steps,
        is_complex=is_complex,
    )


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _decode_seg(seg_arr):
    """-> (seg, word32, (bit1, bit2, bit4)) for either segment format."""
    if seg_arr.dtype == jnp.int16:
        w = seg_arr.astype(jnp.int32) & 0xFFFF
        return (w & (_SEG16_MAX_COLS // LANES - 1), w,
                (1 << _SEG16_BITS, 1 << (_SEG16_BITS + 1),
                 1 << (_SEG16_BITS + 2)))
    return seg_arr & 0xFFFF, seg_arr, (1 << 16, 1 << 17, 1 << 18)


def _scan_runs(p, word, bits, scan_steps: int, roll):
    """Masked Hillis-Steele suffix scan: sum runs into their head slots.

    The mask is a ``where`` select (NOT a float multiply): with a
    multiply, a NaN/Inf rolled in from an unrelated slot would survive
    ``0 * NaN`` and poison the run head."""
    for k, bit in list(zip((1, 2, 4), bits))[:scan_steps]:
        m = (word & bit) > 0
        p = jnp.where(m, p + roll(p, k), p)
    return p


def _decode_inv(inv8):
    iv = inv8.astype(jnp.int32)          # sign-extends: valid -> negative
    return iv & (LANES - 1), (iv < 0)


def gell_tiles(seg_packed, val, inv, x_pad, ng: int, scan_steps: int):
    """Evaluate the packed tiles for one real plane of values against one
    real plane of x; complex callers run this once per product."""
    seg, word, bits = _decode_seg(seg_packed)
    lane = jnp.arange(LANES, dtype=jnp.int32)[None, :, None]
    t = jnp.take(x_pad, seg * LANES + lane, axis=0)
    p = val * t.astype(val.dtype)
    p = _scan_runs(p, word, bits, scan_steps,
                   lambda q, k: jnp.roll(q, -k, axis=2))
    n_tiles = seg_packed.shape[0]
    inv4 = inv.reshape(n_tiles, ng, LANES, LANES)
    idx, valid = _decode_inv(inv4)
    q = jnp.where(valid, jnp.take_along_axis(p[:, None], idx, axis=3),
                  jnp.zeros((), p.dtype))
    return jnp.sum(q, axis=2).reshape(-1)  # sum over buckets


def _pad_cols(pack: GELLPack) -> int:
    """x length the segment gather reads: n_cols rounded up to 128."""
    return -(-pack.shape[1] // LANES) * LANES


def gell_matvec_planes(pack: GELLPack, x_planes: jax.Array) -> jax.Array:
    """``A @ x`` for a complex pack with ``x`` as (2, n) re/im planes,
    returning (2, n_rows) planes."""
    if not pack.is_complex:
        raise ValueError("gell_matvec_planes: pack is not complex")
    n_rows, n_cols = pack.shape
    ng, steps = pack.ng, pack.scan_steps
    rdt = x_planes.dtype
    xp = jnp.pad(x_planes, ((0, 0), (0, _pad_cols(pack) - n_cols)))
    vr, vi = pack.val[:, 0].astype(rdt), pack.val[:, 1].astype(rdt)
    seg, inv = pack.seg_packed, pack.inv
    yr = (gell_tiles(seg, vr, inv, xp[0], ng, steps)
          - gell_tiles(seg, vi, inv, xp[1], ng, steps))
    yi = (gell_tiles(seg, vr, inv, xp[1], ng, steps)
          + gell_tiles(seg, vi, inv, xp[0], ng, steps))
    y = jnp.stack([yr[:n_rows], yi[:n_rows]])
    if pack.n_spill:
        svr = pack.sp_vals[0].astype(rdt)
        svi = pack.sp_vals[1].astype(rdt)
        xgr = jnp.take(x_planes[0], pack.sp_cols, axis=0)
        xgi = jnp.take(x_planes[1], pack.sp_cols, axis=0)
        y = y.at[0, pack.sp_rows].add(svr * xgr - svi * xgi)
        y = y.at[1, pack.sp_rows].add(svr * xgi + svi * xgr)
    return y


def gell_matvec(pack: GELLPack, x: jax.Array) -> jax.Array:
    """``A @ x`` for a packed operator."""
    n_rows, n_cols = pack.shape
    if pack.is_complex:
        rdt = jnp.float64 if np.dtype(x.dtype) == np.dtype(np.complex128) \
            else jnp.float32
        planes = jnp.stack([jnp.real(x).astype(rdt), jnp.imag(x).astype(rdt)])
        y = gell_matvec_planes(pack, planes)
        return jax.lax.complex(y[0], y[1]).astype(x.dtype)

    xp = jnp.pad(x, (0, _pad_cols(pack) - n_cols))
    y = gell_tiles(pack.seg_packed, pack.val.astype(x.dtype), pack.inv, xp,
                   pack.ng, pack.scan_steps)[:n_rows]
    if pack.n_spill:
        y = y.at[pack.sp_rows].add(pack.sp_vals.astype(x.dtype)
                                   * jnp.take(x, pack.sp_cols, axis=0))
    return y
