"""PyTorch port: how flash_attention's wrapper routes a call, on the CPU.

The CUDA kernels run only on the card (``test_torch_cuda.py``); what the
wrapper decides before a launch is plain Python and is held here, on CPU
tensors and without launching: which variant takes a call (the TMA/wgmma
``"hopper"`` kernel or the ``"generic"`` one) and the geometry of the TMA
tensor maps it hands to the C side.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fk


def model_views(b, s, h, kvh, d, dtype=torch.bfloat16, sk=None):
    """q/k/v as the model hands them over: [B,S,*,D] viewed as [B,*,S,D]."""
    sk = s if sk is None else sk
    return (torch.zeros(b, s, h, d, dtype=dtype).transpose(1, 2),
            torch.zeros(b, sk, kvh, d, dtype=dtype).transpose(1, 2),
            torch.zeros(b, sk, kvh, d, dtype=dtype).transpose(1, 2))


def offset_view(t):
    """``t``'s values in storage that starts one element past 16 bytes."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.transpose(1, 2).shape).transpose(1, 2)


@pytest.mark.parametrize("case,args,want", [
    ("qwen2 D128", dict(b=1, s=300, h=16, kvh=2, d=128), "hopper"),
    ("smollm D64", dict(b=2, s=32, h=16, kvh=3, d=64), "hopper"),
    ("llama3 D128", dict(b=1, s=129, h=32, kvh=8, d=128), "hopper"),
    ("fp32", dict(b=1, s=300, h=16, kvh=2, d=128, dtype=torch.float32), "generic"),
    ("D16", dict(b=2, s=40, h=4, kvh=1, d=16), "generic"),
    ("D10", dict(b=1, s=33, h=4, kvh=2, d=10), "generic"),
    ("D256", dict(b=1, s=40, h=8, kvh=1, d=256), "generic"),
    ("no keys", dict(b=1, s=8, h=4, kvh=2, d=64, sk=0), "generic"),
])
def test_variant_choice(case, args, want):
    assert fk.choose_variant(*model_views(**args)) == want, case


@pytest.mark.parametrize("which", [0, 1, 2])
def test_variant_choice_storage_offset_one_element_takes_generic(which):
    views = list(model_views(1, 300, 16, 2, 128))
    views[which] = offset_view(views[which])
    assert views[which].storage_offset() == 1
    assert fk.choose_variant(*views) == "generic"


def test_variant_choice_stride_off_16_bytes_takes_generic():
    """A position stride of 9 * 64 bf16 elements (1152 bytes) is fine; 64
    columns cut from rows of 68 (136 bytes) are not a multiple of 16."""
    q, k, v = model_views(1, 50, 9, 3, 64)
    assert fk.choose_variant(q, k, v) == "hopper"
    wide = torch.zeros(1, 50, 3, 68, dtype=torch.bfloat16)[..., :64].transpose(1, 2)
    assert fk.choose_variant(q, wide, v) == "generic"


def test_variant_choice_contiguous_inputs_take_hopper():
    q, k, v = (t.contiguous() for t in model_views(1, 130, 4, 2, 64))
    assert fk.choose_variant(q, k, v) == "hopper"


def test_tensor_map_geometry_of_qwen2_views():
    """qwen2-1.5b at a 4096-token prompt: q [1,4096,16,128], k [1,4096,2,128]
    as views.  Dims (D, S, heads, B), byte strides of S, heads, B; a D-128
    row is two 64-column boxes of 128 rows."""
    q, k, _ = model_views(1, 4096, 16, 2, 128)
    gq, gk = fk.tensor_map_geometry(q), fk.tensor_map_geometry(k)
    assert gq.dims == (128, 4096, 16, 1)
    assert gq.strides == (4096, 256, 4096 * 4096)
    assert gk.dims == (128, 4096, 2, 1)
    assert gk.strides == (512, 256, 4096 * 512)
    assert gq.box == gk.box == (64, 128, 1, 1)
    assert gq.dims[0] // gq.box[0] == 2                  # two 64-column boxes a row


def test_tensor_map_geometry_of_smollm_and_contiguous_tensors():
    q, k, _ = model_views(2, 32, 16, 3, 64)
    g = fk.tensor_map_geometry(q)
    assert g.dims == (64, 32, 16, 2) and g.strides == (2048, 128, 32 * 2048)
    assert g.box == (64, 128, 1, 1) and g.dims[0] // g.box[0] == 1
    c = torch.zeros(2, 4, 130, 128, dtype=torch.bfloat16)           # [B, H, S, D]
    gc = fk.tensor_map_geometry(c)
    assert gc.dims == (128, 130, 4, 2)
    assert gc.strides == (256, 130 * 256, 4 * 130 * 256)


def test_tensor_map_geometry_size_one_dims_take_packed_strides():
    """A size-1 dimension is never stepped over: whatever stride PyTorch
    reports for it, the map gets the packed one (a multiple of 16)."""
    t = torch.zeros(1, 50, 1, 64, dtype=torch.bfloat16).transpose(1, 2)
    odd = torch.as_strided(t, t.shape, (7, 3, t.stride(2), 1))
    g = fk.tensor_map_geometry(odd)
    assert g.dims == (64, 50, 1, 1)
    assert g.strides == (t.stride(2) * 2, 50 * 64 * 2, 50 * 64 * 2)
    assert fk.choose_variant(odd, odd, odd) == "hopper"


def test_forced_variants_are_checked_before_any_launch():
    q, k, v = model_views(1, 16, 4, 2, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="every input must be on one CUDA device"):
        fk.flash_attention(q, k, v, variant="hopper")
    assert fk.VARIANTS == ("hopper", "generic")
    assert set(fk.variant_counts) == set(fk.VARIANTS)


def test_cpu_tensors_never_count_a_launch():
    """On CPU tensors ``ops`` runs the plain version: no variant counts."""
    from repro_torch.kernels.flash_attention import ops

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
               for s in ((1, 4, 20, 64), (1, 2, 20, 64), (1, 2, 20, 64)))
    before = dict(fk.variant_counts)
    out = ops.flash_attention(q, k, v)
    assert out.shape == q.shape and fk.variant_counts == before


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """The build's library name hashes the source and every local header it
    includes (also through another header), so editing a header rebuilds."""
    from repro_torch import kernels as K

    assert (K.CSRC / "sm90.cuh").resolve() in K._local_headers(K.CSRC / "flash_attention.cu")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(K, "CSRC", tmp_path)
    assert [p.name for p in K._local_headers(tmp_path / "k.cu")] == ["a.cuh", "b.cuh"]
    before = K._lib_path("k")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert K._lib_path("k") != before
