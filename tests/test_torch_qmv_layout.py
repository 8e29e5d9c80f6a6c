"""K2's bit-level design on the CPU, where no card runs it: numpy models of
the nibble -> bf16 dequantization and of the MMA fragment -> output column
mapping of `csrc/qmv.cu`, built from the constants and index expressions
read out of that source, and the plan of tile, chunk and cluster size."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from instructany2pix_tpu_torch.ops import quant as Q

SRC = (Path(Q.__file__).resolve().parent.parent / "csrc" / "qmv.cu").read_text()
SEVEN_B = [(4096, 12288, False, True), (4096, 4096, False, False), (4096, 22016, False, True),
           (11008, 4096, True, False)]  # K, N, SwiGLU, RMSNorm


def _device_fn(name, *args):
    """A one-line `__device__` helper of qmv.cu as a Python function: its
    return expression is valid Python for these integer operators."""
    m = re.search(rf"__device__ __forceinline__ int {name}\([^)]*\) {{\s*return (.*?);\s*}}",
                  SRC, re.S)
    assert m, f"{name} not found in qmv.cu"
    return eval(f"lambda {', '.join(args)}: {' '.join(m.group(1).split())}")  # noqa: S307


slot_of = _device_fn("slot_of", "rho")
swizzled = _device_fn("swizzled", "r", "c")


def _hex(pattern):
    m = re.search(pattern, SRC)
    assert m, pattern
    return int(m.group(1), 16)


def _bf16(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _dequant_word(w, b):
    """The kernel's `dequant_pair<b>` on a uint32 word w: (low half, high
    half) as float."""
    v = np.uint32(w)
    v4 = v >> np.uint32(int(re.search(r"v4\[q\] = v\[q\] >> (\d+);", SRC).group(1)))
    pool = [(int(v) >> (8 * i)) & 0xFF for i in range(4)] + [(int(v4) >> (8 * i)) & 0xFF
                                                             for i in range(4)]
    assert "B | ((B + 4) << 8)" in SRC
    sel = b | ((b + 4) << 8)
    r = sum(pool[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))
    m = re.search(r'lop3\.b32 %0, %1, %2, %3, (0x[0-9A-F]{2});\\n" : "=r"\(r\) : "r"\(r\), '
                  r'"r"\((0x[0-9A-F]{8})u\), "r"\((0x[0-9A-F]{8})u\)', SRC)
    assert m and m.group(1) == "0x6A", "lop3's function is (a & b) ^ c"
    r = (r & int(m.group(2), 16)) ^ int(m.group(3), 16)
    one, minus = _hex(r'"r"\((0x3F803F80)u\)'), _hex(r'"r"\((0xC308C308)u\)')
    lo, hi = _bf16([r & 0xFFFF, r >> 16])
    return (lo * _bf16(one & 0xFFFF) + _bf16(minus & 0xFFFF),
            hi * _bf16(one >> 16) + _bf16(minus >> 16))


def test_nibble_to_bf16_matches_unpack_int4():
    """Every byte value, in each byte position of a word, dequantizes to the
    two signed nibbles `unpack_int4` reads from it (low nibble: row 2i)."""
    packed = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(torch.int8)
    want = Q.unpack_int4(packed.reshape(1, 256)).numpy()  # (2, 256): rows 0 and 1
    for b in range(4):
        got = np.zeros((2, 256), np.float32)
        for byte in range(256):
            word = (byte << (8 * b)) | (0x5A << (8 * ((b + 1) % 4)))  # a neighbour byte too
            got[0, byte], got[1, byte] = _dequant_word(word, b)
        np.testing.assert_array_equal(got, want.astype(np.float32), err_msg=f"byte {b}")


def _tma_offset(r, col):
    """Where TMA's 128-byte swizzle puts byte `col` of 128-byte row `r`."""
    return r * 128 + ((((col // 16) ^ (r % 8)) * 16) | (col % 16))


def test_fragment_reads_are_swizzled_and_bank_conflict_free():
    """The thread's four 8-byte reads per k16 step land on columns
    8 slot_of(rho) .. + 7 of its two byte rows as TMA placed them, and the
    16 lanes of each half-warp read 16 different 8-byte bank pairs."""
    assert sorted(slot_of(rho) for rho in range(16)) == list(range(16))
    for q, (dr, dg) in enumerate([(0, 0), (0, 8), (4, 0), (4, 8)]):
        for half in range(2):
            banks = set()
            for lane in range(16 * half, 16 * half + 16):
                g, t = lane // 4, lane % 4
                r, c = t + dr, slot_of(g + dg)
                off = swizzled(r, c)
                assert off == _tma_offset(r, 8 * c), (q, lane)
                banks.add((off % 128) // 8)
            assert len(banks) == 16, f"read {q}, half-warp {half}: {16 - len(banks)} conflicts"


def _dequant_byte(byte):
    lo, hi = _dequant_word(int(byte), 0)
    return lo, hi


@pytest.mark.parametrize("m", [1, 5, 16])
def test_fragment_to_column_mapping_reproduces_the_product(m):
    """A numpy model of the mma path on one stage (64 byte rows, 128
    columns): each thread's A fragments from its swizzled byte reads, B from
    x' rows g and g + 8, m16n8k16 as PTX lays it out, C written to column
    8 slot_of(rho) + j. Every column of the tile is written once per row of
    x, and the result is x @ dequant(W) exactly (small integers)."""
    rs = np.random.RandomState(m)
    packed = rs.randint(-128, 128, size=(64, 128)).astype(np.int8)
    x = rs.randint(-3, 4, size=(m, 128)).astype(np.float64)
    smem = np.zeros(64 * 128, np.uint8)
    for r in range(64):
        for col in range(128):
            smem[_tma_offset(r, col)] = packed[r, col].view(np.uint8)
    table = {byte: _dequant_byte(byte) for byte in range(256)}
    y = np.zeros((m, 128))
    writes = np.zeros((m, 128), int)
    nt_count = 1 if m <= 8 else 2
    for j in range(8):
        d = np.zeros((nt_count, 16, 8))
        for step in range(8):
            a = np.zeros((16, 16))
            bmat = np.zeros((nt_count, 16, 8))
            for lane in range(32):
                g, t = lane // 4, lane % 4
                reads = [(t, g), (t, g + 8), (t + 4, g), (t + 4, g + 8)]
                frag = []
                for r, rho in reads:
                    off = step * 8 * 128 + swizzled(r, slot_of(rho))
                    frag.append(table[int(smem[off + j])])
                # a0: row g, k 2t..; a1: row g+8; a2: row g, k 2t+8..; a3: row g+8, k 2t+8..
                for (row, k0), (lo, hi) in zip([(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                                (g + 8, 2 * t + 8)], frag):
                    a[row, k0], a[row, k0 + 1] = lo, hi
                for nt in range(nt_count):
                    mm = g + 8 * nt
                    for kk in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9):
                        bmat[nt, kk, g] = x[mm, step * 16 + kk] if mm < m else 0.0
            for nt in range(nt_count):
                d[nt] += a @ bmat[nt]
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for nt in range(nt_count):
                for e in range(4):
                    mm = 8 * nt + 2 * t + (e & 1)
                    rho = g if e < 2 else g + 8
                    col = 8 * slot_of(rho) + j
                    if mm < m:
                        y[mm, col] = d[nt, rho, 2 * t + (e & 1)]
                        writes[mm, col] += 1
    assert (writes == 1).all()
    w = Q.unpack_int4(torch.from_numpy(packed)).double().numpy()  # (128, 128)
    np.testing.assert_array_equal(y, x @ w)


@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("k,n,swiglu,norm", SEVEN_B)
def test_plan_at_the_7b_shapes(k, n, swiglu, norm, m):
    """Chunks are whole scale groups, cover K exactly (no empty block), the
    cluster is at most 8, the plan is the one measured at this shape, and
    bf16 with int4 weights takes the tensor cores."""
    p = Q.qmv_plan(m, k, n, "int4g", torch.bfloat16, swiglu, norm)
    assert p.path == "mma" and p.tile == Q.QMV_TILE_N
    assert p.chunk % Q.QMV_GROUP == 0 and p.chunk == p.chunk_stages * 2 * Q.QMV_STAGE_ROWS
    assert p.chunk * p.cluster >= k > p.chunk * (p.cluster - 1)
    assert 1 <= p.cluster <= Q.QMV_MAX_CLUSTER
    want_cluster, want_ring = Q._PLANS[(m, k, n, "int4g", "bfloat16", swiglu, norm)]
    assert (p.cluster, p.ring) == (want_cluster, min(want_ring, p.chunk_stages))
    # each slot of the ring belongs to one of the 4 consumer warps, or no slot is used twice
    assert p.ring % 4 == 0 or p.ring == p.chunk_stages


@pytest.mark.parametrize("fmt,dtype,m,k,n", [
    ("int8", torch.bfloat16, 1, 4096, 4096), ("int4", torch.float32, 16, 11008, 4096),
    ("int4g", torch.float32, 3, 256, 384), ("int4", torch.bfloat16, 2, 200, 256),
])
def test_plan_paths_and_cover(fmt, dtype, m, k, n):
    p = Q.qmv_plan(m, k, n, fmt, dtype)
    assert p.path == Q.qmv_path(fmt, dtype) == ("mma" if dtype == torch.bfloat16
                                                and fmt != "int8" else "fma")
    kstage = Q.QMV_STAGE_ROWS * (1 if fmt == "int8" else 2)
    assert p.stages == -(-k // kstage) and p.chunk == p.chunk_stages * kstage
    assert p.chunk_stages * p.cluster >= p.stages > p.chunk_stages * (p.cluster - 1)
    assert p.ring <= p.chunk_stages and (p.ring % 4 == 0 or p.ring == p.chunk_stages)


@pytest.mark.parametrize("m,k,n,fmt,dtype,swiglu,norm", [
    (16, 16384, 4096, "int4g", torch.float32, True, True),
    (16, 28672, 8192, "int4g", torch.bfloat16, True, False),
    (16, 28672, 4096, "int4g", torch.bfloat16, True, True),
    (1, 1 << 20, 128, "int8", torch.bfloat16, False, True),
])
def test_plan_takes_any_k(m, k, n, fmt, dtype, swiglu, norm):
    """A chunk whose x' does not fit the shared memory is staged in windows
    by the kernel, so the plan has no K it refuses: chunks of whole stages
    that cover K, at most 8 of them."""
    p = Q.qmv_plan(m, k, n, fmt, dtype, swiglu, norm)
    kstage = Q.QMV_STAGE_ROWS * (1 if fmt == "int8" else 2)
    assert p.chunk == p.chunk_stages * kstage and 1 <= p.cluster <= Q.QMV_MAX_CLUSTER
    assert p.chunk_stages * p.cluster >= p.stages > p.chunk_stages * (p.cluster - 1)
    assert p.ring <= p.chunk_stages and (p.ring % 4 == 0 or p.ring == p.chunk_stages)


@pytest.mark.parametrize("group,dtype,path", [
    (128, torch.bfloat16, "mma"), (256, torch.bfloat16, "mma"), (64, torch.bfloat16, "fma"),
    (32, torch.bfloat16, "fma"), (128, torch.float32, "fma"),
])
def test_path_by_group(group, dtype, path):
    """The tensor cores take int4 groups of 128 or a multiple of it, where
    a stage (128 k) lies in one group; other groups take the CUDA cores."""
    assert Q.qmv_path("int4g", dtype, group) == path
    assert Q.qmv_plan(1, 4096, 4096, "int4g", dtype, group=group).path == path


def test_kernel_takes_every_even_group():
    """The kernel reads the scale row of any even group that divides K: by
    TMA per stage when 128 divides the group, from global memory at each
    group's end otherwise (no group size is refused in the source)."""
    assert "group < 2 || group % 2 || K % group" in SRC
    assert "(s0 + s) * kK / p.group" in SRC


def test_reset_counts_zeroes_every_path():
    Q.qmv_cuda.launches = 3
    Q.qmv_cuda.launches_by_path["mma"] = 3
    Q.reset_qmv_counts()
    assert Q.qmv_cuda.launches == 0
    assert Q.qmv_cuda.launches_by_path == dict.fromkeys(Q.QMV_PATHS, 0)


def test_fma_weight_conversion_is_exact():
    """The fma path's int8 and int4 weights become float32 through the
    mantissa of 2^23 (no I2F): over every byte value, the constants read
    out of the source give the byte's int8 value and `unpack_int4`'s two
    nibbles."""
    magic8 = float(re.search(r"kMagic8 = ([0-9.]+)f;", SRC).group(1))
    magic4 = float(re.search(r"kMagic4 = ([0-9.]+)f;", SRC).group(1))
    assert "wd ^ (FMT == kInt8 ? 0x80808080u : 0x88888888u)" in SRC
    assert "__byte_perm(u, 0x4B000000u, 0x7540 | c)" in SRC

    def f32(bits):
        return np.array([bits], np.uint32).view(np.float32)[0]

    packed = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(torch.int8)
    nibbles = Q.unpack_int4(packed.reshape(1, 256)).numpy()
    for byte in range(256):
        u8, u4 = byte ^ 0x80, byte ^ 0x88
        # __byte_perm(u, 0x4B000000, 0x7540 | c): byte c of u under 0x4B0000
        assert f32(0x4B000000 | u8) - np.float32(magic8) == packed[byte].item()
        lo = f32(0x4B000000 | (u4 & 0xF)) - np.float32(magic4)
        hi = f32(0x4B000000 | (u4 >> 4 & 0xF)) - np.float32(magic4)
        assert (lo, hi) == (nibbles[0, byte], nibbles[1, byte]), byte
