"""The dry run's closed forms and roofline against the JAX reference, bit
for bit, and what its trace counts.

* ``_avg_kv``, ``inner_corrections``, ``analytic_model_flops`` and
  ``active_params`` equal the reference's for every arch and cell
  (``==`` on floats); ``Roofline``'s fields equal the reference's with
  the reference's TPU v5e constants passed in.
* The FLOP count: a reduced dense prefill's ``traced_flops`` (and a
  decode step's) equal the hand-computed ``2 M N K`` sum of its matmuls
  exactly; the attention kernels' meta branch adds nothing to it, and
  ``kernel_call_corrections`` gives ``inner_corrections``' attention
  terms for the calls it recorded.
* The bytes model: a view moves nothing, an op reads its arguments and
  writes its outputs once, an overwrite skips reading its target, a
  scatter writes only its rows.
"""
import dataclasses

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import hlo_analysis as jhlo
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.models.model_api import SHAPE_CELLS, Model

B, S = 2, 24


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def test_avg_kv_bit_equal():
    for s in (1, 2, 7, 24, 4096, 32_768, 524_288):
        for w in (None, 1, 16, 4095, 4096, 4097, 2 ** 30):
            assert hlo._avg_kv(s, w) == jhlo._avg_kv(s, w), (s, w)


def _variants(arch):
    """The arch's config and the knobs the closed forms read."""
    for over in ({}, {"remat": False}, {"dtype": "float32"},
                 {"q_block": 1024, "rwkv_chunk": 64}):
        yield (dataclasses.replace(get_config(arch), **over),
               dataclasses.replace(jget_config(arch), **over))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_closed_forms_bit_equal(arch):
    for cfg, jcfg in _variants(arch):
        assert hlo.active_params(cfg) == jhlo.active_params(jcfg)
        for cell in SHAPE_CELLS.values():
            for kind in (cell.kind, "train", "prefill", "decode"):
                assert hlo.inner_corrections(
                    cfg, kind, cell.global_batch, cell.seq_len) == \
                    jhlo.inner_corrections(jcfg, kind, cell.global_batch,
                                           cell.seq_len), (cell, kind)
            n_tok = cell.global_batch * cell.seq_len
            for kind in ("train", "serve"):
                assert hlo.analytic_model_flops(cfg, n_tok, kind) == \
                    jhlo.analytic_model_flops(jcfg, n_tok, kind)


@pytest.mark.parametrize("flops,nbytes,coll,n_dev,model_flops", [
    (1.5e14, 3.2e11, 4.0e9, 256, 1.1e17),      # compute-bound
    (2.0e11, 9.7e10, 1.0e8, 512, 3.0e15),      # memory-bound
    (1.0e10, 1.0e9, 6.4e10, 256, None),        # collective-bound, no model
    (0.0, 8.4e7, 0.0, 16, None),               # the AMPER cell's shape
])
def test_roofline_fields_equal_reference(flops, nbytes, coll, n_dev,
                                         model_flops):
    got = hlo.Roofline(flops, nbytes, coll, n_dev, model_flops,
                       peak_flops=jhlo.PEAK_FLOPS_BF16, hbm_bw=jhlo.HBM_BW,
                       link_bw=jhlo.ICI_BW)
    want = jhlo.Roofline(flops, nbytes, coll, n_dev, model_flops)
    assert got.as_dict() == want.as_dict()
    assert got.step_time_lower_bound == want.step_time_lower_bound
    # on the H100, with no sharded program yet: no collective term
    h100 = hlo.Roofline(flops, nbytes, None, n_dev, model_flops)
    assert (h100.peak_flops, h100.hbm_bw) == (989e12, 3.35e12)
    d = h100.as_dict()
    assert d["t_collective_s"] is None and d["coll_bytes_per_dev"] is None
    assert d["t_memory_s"] == nbytes / 3.35e12
    assert d["bottleneck"] == ("compute" if flops / 989e12 > nbytes / 3.35e12
                               else "memory")


def _prog(model, kind):
    """A reduced prefill or decode step on meta inputs (B x S)."""
    p = model.abstract_params()
    if kind == "prefill":
        toks = torch.empty((B, S), dtype=torch.int32, device="meta")
        return dryrun.Program(
            lambda p, b: model.prefill(p, b, max_len=S + 8),
            (p, {"tokens": toks}), ())
    toks = torch.empty((B, 1), dtype=torch.int32, device="meta")
    return dryrun.Program(model.decode_step,
                          (p, toks, model.init_cache(B, S, device="meta")),
                          ())


def _matmul_flops(cfg, tokens):
    """2 M N K over the projections and the MLP of every layer (M =
    tokens), and the unembedding of the last position of each row."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Hq, Hkv, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_token = D * Hq * Hd + 2 * D * Hkv * Hd + Hq * Hd * D + 3 * D * F
    return cfg.n_layers * 2 * tokens * per_token + 2 * B * D * V


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_traced_flops_are_the_matmuls(kind):
    cfg = get_reduced_config("stablelm-1.6b", n_layers=3)
    assert cfg.mlp_kind == "swiglu" and cfg.block_kind == "attn"
    q = dryrun._trace(_prog(Model.from_config(cfg), kind), cfg)
    tokens = B * (S if kind == "prefill" else 1)
    assert q["flops"] == _matmul_flops(cfg, tokens)
    name = "flash_attention" if kind == "prefill" else "decode_attention"
    assert q["terms"] == {name: cfg.n_layers}
    # the recorded calls' closed form is inner_corrections' attention
    # term (decode: the whole cache, as the reference counts it)
    want = hlo.inner_corrections(cfg, kind, B, S)
    assert q["correction_flops"] == pytest.approx(want["flops"], rel=1e-12)
    assert q["correction_bytes"] == pytest.approx(want["bytes"], rel=1e-12)
    assert q["bytes"] > 0 and q["peak_live_bytes"] > 0


def test_kernel_call_corrections_window_gqa_and_cross():
    """A windowed GQA flash call, a non-causal cross call and a grouped
    decode call, each by its closed form."""
    cfg = get_reduced_config("h2o-danube-3-4b")
    bf = torch.bfloat16
    calls = [("flash_attention", {"q": (2, 8, 100, 16), "k": (2, 2, 100, 16),
                                  "v": (2, 2, 100, 16), "dtype": bf,
                                  "causal": True, "window": 32,
                                  "prefix_len": None}),
             ("flash_attention", {"q": (2, 6, 10, 16), "k": (2, 6, 16, 16),
                                  "v": (2, 6, 16, 16), "dtype": torch.float32,
                                  "causal": False, "window": None,
                                  "prefix_len": None}),
             ("decode_attention", {"q": (2, 2, 4, 16), "k": (2, 2, 64, 16),
                                   "v": (2, 2, 64, 16), "dtype": bf,
                                   "window": 32})]
    got = hlo.kernel_call_corrections(cfg, calls)
    nq = max(100 // cfg.q_block, 1)
    kv = hlo._avg_kv(100, 32)
    f = 2.0 * 2 * 8 * 100 * kv * 32
    b = nq * 2 * 2 * kv * 32 * 2 + 2 * 2 * 8 * 100 * 16 * 2
    f += 2.0 * 2 * 6 * 10 * 16 * 32
    b += 2 * 6 * 16 * 32 * 4 + 2 * 2 * 6 * 10 * 16 * 4
    f += 2.0 * 2 * 8 * 1 * 32 * 32
    b += 2 * 2 * 32 * 32 * 2 + 2 * 2 * 8 * 1 * 16 * 2
    assert got["flops"] == pytest.approx(f, rel=1e-12)
    assert got["bytes"] == pytest.approx(b, rel=1e-12)
    assert got["terms"] == {"flash_attention": 2, "decode_attention": 1}


def test_moved_bytes_model():
    aten = torch.ops.aten
    x = torch.empty((4, 8), device="meta")
    y = torch.empty((4, 8), device="meta")
    assert dryrun._moved_bytes(aten.add.Tensor, (x, y), {}, [x]) == 3 * 128
    assert dryrun._moved_bytes(aten.view.default, (x, [32]), {}, [x]) == 0
    assert dryrun._moved_bytes(aten.empty.memory_format, ([4, 8],), {},
                               [x]) == 0
    assert dryrun._moved_bytes(aten.copy_.default, (x, y), {}, [x]) == 256
    idx = torch.empty((1,), dtype=torch.int64, device="meta")
    row = torch.empty((1, 8), device="meta")
    assert dryrun._moved_bytes(aten.index_copy_.default, (x, 0, idx, row),
                               {}, [x]) == 8 + 2 * 32
    # inside a trace: live bytes start at the inputs; the sum lives until
    # the product is made
    with dryrun._Trace([x, y]) as tr:
        z = (x + y) * 2.0
    assert tr.peak == 4 * 128 and tr.bytes == 3 * 128 + 2 * 128
    assert tr.live == 3 * 128
    del z
    assert tr.live == 2 * 128
