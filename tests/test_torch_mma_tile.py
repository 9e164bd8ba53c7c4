"""The bfloat16 tensor-core tile of the grad-step kernels, built for the host.

``csrc/ppo_math.cuh`` runs the bf16 grad step's three H x H products as
``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`` tiles.  A host
build (g++, one thread) runs the same fragment loads and emulates each
``mma`` instruction: it places every lane's A and B elements by the
fragment maps and adds to each C element its 16 exact products, summed in
float32 in k order.  Here:

* the maps against the PTX ISA's figures for m16n8k16 with .bf16 operands,
  transcribed independently below;
* one warp's group of four tiles through the ldmatrix row addresses (a
  host build gathers each lane's registers from the 32 lanes' addresses as
  ldmatrix does) and the emulated mma, for the three operand forms of the
  grad step (h1 feature-major times W2, dg2 times W2^T, and dW2's form that
  contracts rows), with a zero pad, against ``torch.matmul`` of the same
  bfloat16 operands in float32.  Products of bfloat16 values are exact in float32, so the two
  differ only in the order of the sums: each element within K float32
  roundings of its absolute sum, ``K * 2^-24 * (|A| @ |B|)``;
* fragments built with a lane's a2/a3 rows swapped (rows g and g + 8 of A
  exchanged) give a wrong product, so the emulation reads the maps.
"""

import numpy as np
import pytest
import torch

from test_torch_kernel_host import host_lib  # noqa: F401

torch.set_num_threads(1)

BF16 = torch.bfloat16


def _ptx_maps():
    """The PTX ISA's fragment layout of mma.m16n8k16 (.bf16 A and B, .f32
    C) for lane = 4 * groupID + threadID_in_group: [32, 16, 2] (row, col)
    of a0..a7, b0..b3, c0..c3."""
    out = np.zeros((32, 16, 2), np.int32)
    for lane in range(32):
        g, t = lane >> 2, lane % 4
        for i in range(8):  # a_i: rows groupID (a0, a1, a4, a5) or groupID + 8
            row = g if i in (0, 1, 4, 5) else g + 8
            col = t * 2 + (i & 1) + (8 if i >= 4 else 0)
            out[lane, i] = row, col
        for i in range(4):  # b_i: rows threadID_in_group * 2 + (i & 1) (+ 8 for b2, b3)
            out[lane, 8 + i] = t * 2 + (i & 1) + (8 if i >= 2 else 0), g
        for i in range(4):  # c_i: rows groupID (c0, c1) or groupID + 8
            out[lane, 12 + i] = g + (8 if i >= 2 else 0), t * 2 + (i & 1)
    return out


def test_fragment_maps_are_the_ptx_layout(host_lib):
    got = np.zeros((32, 16, 2), np.int32)
    host_lib.host_mma_maps(got.ctypes.data)
    np.testing.assert_array_equal(got, _ptx_maps())


def _rounded(rng, shape):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(BF16).float()


# (form, A's layout: its rows run along k, B's likewise).  A and B are the
# product's operands as rows by depth: C[m, n] = sum_k A[m, k] B[n, k].
FORMS = {
    "h1_w2": (False, False),  # h1 [K, R+8] feature-major times W2 [K, HB+8]
    "dg2_w2T": (False, True),  # dg2 [K, R+8] times W2 [N, HB+8] along its rows
    "dw2_rows": (True, True),  # h1 [M, R+8] and dg2 [N, R+8], both along the rows r
}


def _bf16_buffer(M, kc):
    """M [rows, K] as the kernel's bfloat16 layout: element (i, k) at [i, k]
    (kc) or [k, i], each memory row 8 elements longer than its extent and
    that pad NaN (no fragment may read it)."""
    X = M if kc else M.T
    buf = torch.full((X.shape[0], X.shape[1] + 8), float("nan"), dtype=BF16)
    buf[:, :X.shape[1]] = X.to(BF16)
    return buf.contiguous(), buf.shape[1]


@pytest.mark.parametrize("K,zero_from", [(16, None), (32, None), (48, (12, 20, 40))])
@pytest.mark.parametrize("form", list(FORMS))
def test_one_group_matches_matmul(host_lib, form, K, zero_from):
    """One warp's group, a 16 x 32 block of four 8-column tiles over depth
    K, through the ldmatrix row addresses and fragments and the emulated
    mma: against matmul of the same operands.  zero_from: (m, n, k) past
    which the operands hold zeros, as the kernel pads a ragged H."""
    akc, bkc = FORMS[form]
    rng = np.random.default_rng(K + 7 * len(form))
    A, B = _rounded(rng, (16, K)), _rounded(rng, (32, K))
    if zero_from:
        m, n, k = zero_from
        A[m:], A[:, k:], B[n:], B[:, k:] = 0, 0, 0, 0
    abuf, as_ = _bf16_buffer(A, akc)
    bbuf, bs_ = _bf16_buffer(B, bkc)
    out = torch.full((16, 32), float("nan"))
    host_lib.host_mma_tile(int(akc), abuf.data_ptr(), as_, int(bkc), bbuf.data_ptr(), bs_, K,
                           out.data_ptr())
    ref = A @ B.T
    bound = K * 2.0 ** -24 * (A.abs() @ B.abs().T)
    assert torch.isfinite(out).all()
    assert bool(((out - ref).abs() <= bound).all()), float((out - ref).abs().max())
    if zero_from:
        assert bool((out[zero_from[0]:] == 0).all()) and bool((out[:, zero_from[1]:] == 0).all())


def _pack(lo, hi):
    """Two float32 tensors of bfloat16 values packed as the registers hold
    them: lo in the low 16 bits."""
    bits = lambda x: x.to(BF16).view(torch.int16).to(torch.int64) & 0xFFFF  # noqa: E731
    return (bits(lo) | (bits(hi) << 16)).to(torch.int64)


def _fragments(A, B, swap_a23=False):
    """A [16, 16] (m, k) and B [16, 8] (k, n) as the 32 lanes' registers by
    the PTX layout: [32, 4] and [32, 2] uint32 (held as int64 here).
    swap_a23: each lane's a2/a3 taken from the rows of a0/a1 and back."""
    maps = _ptx_maps()
    a = torch.zeros(32, 4, dtype=torch.int64)
    b = torch.zeros(32, 2, dtype=torch.int64)
    for lane in range(32):
        ael = [A[maps[lane, i, 0], maps[lane, i, 1]] for i in range(8)]
        if swap_a23:
            ael[0:2], ael[2:4] = ael[2:4], ael[0:2]
        for r in range(4):
            a[lane, r] = _pack(ael[2 * r], ael[2 * r + 1])
        bel = [B[maps[lane, 8 + i, 0], maps[lane, 8 + i, 1]] for i in range(4)]
        for r in range(2):
            b[lane, r] = _pack(bel[2 * r], bel[2 * r + 1])
    return a, b


def _emulate(host_lib, a, b):
    a32 = a.numpy().astype(np.uint32)
    b32 = b.numpy().astype(np.uint32)
    c = np.zeros((32, 4), np.float32)
    host_lib.host_mma_frags(a32.ctypes.data, b32.ctypes.data, c.ctypes.data)
    maps = _ptx_maps()
    out = torch.zeros(16, 8)
    for lane in range(32):
        for i in range(4):
            out[maps[lane, 12 + i, 0], maps[lane, 12 + i, 1]] = float(c[lane, i])
    return out


def test_swapped_a_rows_give_a_wrong_product(host_lib):
    rng = np.random.default_rng(5)
    A, B = _rounded(rng, (16, 16)), _rounded(rng, (16, 8))
    ref = A @ B
    bound = 16 * 2.0 ** -24 * (A.abs() @ B.abs())
    good = _emulate(host_lib, *_fragments(A, B))
    assert bool(((good - ref).abs() <= bound).all())
    bad = _emulate(host_lib, *_fragments(A, B, swap_a23=True))
    assert float((bad - ref).abs().max()) > 0.1
    # the swap exchanges rows g and g + 8 of the k < 8 half of A
    Aswap = A.clone()
    Aswap[:8, :8], Aswap[8:, :8] = A[8:, :8], A[:8, :8]
    assert bool(((bad - Aswap @ B).abs() <= bound).all())
