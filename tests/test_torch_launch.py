"""The port's launch layer against the reference's: sharding rules leaf for
leaf on both production meshes, the cache and batch rules, the analytic
cost model, the mesh helpers and the collective statistics.

The reference's specs come from its rules over a shape-only mesh (the
``FakeMesh`` of ``tests/test_launch.py``), the port's from its rules over a
``DeviceMesh`` on a ``"fake"`` process group of 512 ranks, built once for
the module and destroyed after it.
"""

import dataclasses
import multiprocessing
import os
import queue as queue_mod
import time
import traceback

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from repro.configs import get_config as ref_get_config
from repro.launch import analytic as ref_analytic
from repro.launch import input_specs as ref_input_specs
from repro.launch import sharding as ref_sharding
from repro.models import model_zoo as ref_zoo
from repro_torch import tree as tree_lib
from repro_torch.configs import (
    ARCHITECTURES,
    SHAPES,
    cell_is_applicable,
    get_config,
    get_smoke_config,
)
from repro_torch.configs.base import shape_by_name
from repro_torch.launch import analytic, hlo_analysis, input_specs, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model_zoo as zoo
from repro_torch.optim.optimizer import AdamW


class FakeMesh:
    """Shape-only stand-in for a jax Mesh (the reference's rules never
    touch devices)."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


REF_MESHES = {"pod": FakeMesh(data=16, model=16), "multipod": FakeMesh(pod=2, data=16, model=16)}


@pytest.fixture(scope="module")
def meshes():
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh_lib.fake_world(512)
    try:
        yield {
            "pod": mesh_lib.make_production_mesh(device_type="cpu"),
            "multipod": mesh_lib.make_production_mesh(multi_pod=True, device_type="cpu"),
        }
    finally:
        dist.destroy_process_group()


def _ref_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_leafwise(port_tree, port_specs, ref_tree, ref_specs, what):
    """Every port leaf's spec is its reference leaf's, the stack entry
    dropped; the port's leaves cover every reference leaf."""

    seen = set()
    flat = tree_lib.flatten_with_paths(port_tree)
    assert len(flat) == len(tree_lib.leaves(port_specs))
    for (path, leaf), spec in zip(flat, tree_lib.leaves(port_specs)):
        rpath, rshape, stacked = sharding.reference_leaf(path, tuple(leaf.shape), port_tree)
        rpath = tuple(str(p) for p in rpath)
        assert tuple(_ref_at(ref_tree, rpath).shape) == rshape, (what, path)
        want = tuple(_ref_at(ref_specs, rpath))
        want = want + (None,) * (len(rshape) - len(want))
        if stacked:
            assert want[0] is None, (what, rpath, want)
            want = want[1:]
        assert tuple(spec) == want, (what, path, tuple(spec), want)
        seen.add(rpath)
    import jax

    n_ref = len(jax.tree_util.tree_leaves(ref_tree))
    assert len(seen) == n_ref, (what, len(seen), n_ref)


@pytest.mark.parametrize("arch", ARCHITECTURES)
@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
class TestSpecsEqualTheReference:
    def test_params_and_fsdp(self, arch, mesh_name, meshes):
        mesh, ref_mesh = meshes[mesh_name], REF_MESHES[mesh_name]
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        params, rparams = zoo.abstract_params(cfg), ref_zoo.abstract_params(rcfg)
        _assert_leafwise(
            params, sharding.params_pspecs(cfg, mesh, params),
            rparams, ref_sharding.params_pspecs(rcfg, ref_mesh, rparams), "params",
        )
        _assert_leafwise(
            params, sharding.fsdp_pspecs(cfg, mesh, params),
            rparams, ref_sharding.fsdp_pspecs(rcfg, ref_mesh, rparams), "fsdp",
        )

    @pytest.mark.parametrize("kv_quant", [False, True])
    def test_caches(self, arch, mesh_name, kv_quant, meshes):
        mesh, ref_mesh = meshes[mesh_name], REF_MESHES[mesh_name]
        cfg = dataclasses.replace(get_config(arch), kv_quant=kv_quant)
        rcfg = dataclasses.replace(ref_get_config(arch), kv_quant=kv_quant)
        for shape in SHAPES:
            if shape.kind == "train" or not cell_is_applicable(cfg, shape)[0]:
                continue
            cache = zoo.abstract_cache(cfg, shape.global_batch, shape.seq_len)
            rcache = ref_zoo.abstract_cache(rcfg, shape.global_batch, shape.seq_len)
            _assert_leafwise(
                cache, sharding.cache_pspecs(cfg, mesh, cache),
                rcache, ref_sharding.cache_pspecs(rcfg, ref_mesh, rcache),
                f"cache {shape.name}",
            )
            assert not sharding.validate_divisibility(
                sharding.cache_pspecs(cfg, mesh, cache), cache, mesh
            )

    def test_batches(self, arch, mesh_name, meshes):
        mesh, ref_mesh = meshes[mesh_name], REF_MESHES[mesh_name]
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        for shape in SHAPES:
            b = input_specs.batch_specs(cfg, shape)
            rb = ref_input_specs.batch_specs(rcfg, shape)
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in b.items()} == {
                k: (tuple(v.shape), str(v.dtype)) for k, v in rb.items()
            }
            specs = sharding.batch_pspecs(cfg, mesh, b)
            rspecs = ref_sharding.batch_pspecs(rcfg, ref_mesh, rb)
            assert {k: tuple(v) for k, v in specs.items()} == {
                k: tuple(v) + (None,) * (b[k].dim() - len(v)) for k, v in rspecs.items()
            }

    def test_divisible_and_stack_dim_whole(self, arch, mesh_name, meshes):
        mesh = meshes[mesh_name]
        cfg = get_config(arch)
        params = zoo.abstract_params(cfg)
        for specs in (
            sharding.params_pspecs(cfg, mesh, params),
            sharding.fsdp_pspecs(cfg, mesh, params),
        ):
            assert not sharding.validate_divisibility(specs, params, mesh)
        # the rule in the reference's layout never shards the stack dim
        for path, leaf in tree_lib.flatten_with_paths(params):
            rpath, rshape, stacked = sharding.reference_leaf(path, tuple(leaf.shape), params)
            if stacked:
                spec = sharding.param_spec(tuple(map(str, rpath)), rshape, cfg, mesh)
                assert spec[0] is None


def test_cell_shardings_keys_match_the_reference(meshes):
    """The keys of the reference's dict, per cell kind, and sharding trees
    of the abstract trees' structure."""

    cfg = get_config("granite_3_2b")
    for shape in SHAPES:
        cell = input_specs.cell_shardings(cfg, shape, meshes["pod"], AdamW())
        want = {"params", "params_abstract", "batch", "batch_abstract"}
        if shape.kind == "train":
            want |= {"opt_state", "opt_state_abstract", "grad_shardings"}
        else:
            want |= {"cache", "cache_abstract"}
        assert set(cell) == want
        for k in ("params", "batch", "cache", "opt_state"):
            if k in cell:
                assert len(tree_lib.leaves(cell[k])) == len(tree_lib.leaves(cell[k + "_abstract"]))


def test_placements_follow_mesh_order(meshes):
    from torch.distributed.tensor import Replicate, Shard

    m2 = meshes["multipod"]
    assert sharding.placements(m2, sharding.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2),
    )
    assert sharding.placements(m2, sharding.P(None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sharding.placements(m2, sharding.P(("data", "pod")))
    with pytest.raises(ValueError):
        sharding.placements(m2, sharding.P("data", "data"))


def test_argument_bytes_from_local_shards(meshes):
    """A (256, 64) f32 leaf sharded (data, model) holds 16 × 4 per rank."""

    sh = sharding.NamedSharding(meshes["pod"], sharding.P("data", "model"))
    leaf = torch.empty((256, 64), device="meta")
    assert sharding.local_shape((256, 64), sh) == (16, 4)
    assert input_specs.argument_bytes({"w": leaf}, {"w": sh}) == 16 * 4 * 4


class TestParamSpecRules:
    """``tests/test_launch.py::TestParamSpecRules`` on the port's rules."""

    def test_vocab_sharded_after_padding(self, meshes):
        cfg = get_config("granite_3_2b")  # vocab 49155 → padded 49664
        spec = sharding.param_spec(("embed", "tok"), (cfg.padded_vocab_size, 2048), cfg, meshes["pod"])
        assert spec[0] == "model"

    def test_padded_heads_shard(self, meshes):
        cfg = get_config("llava_next_34b")  # 56 → 64 heads
        assert cfg.padded_num_heads == 64
        spec = sharding.param_spec(
            ("blocks", "pos0", "attn", "wq"), (60, 7168, 64, 128), cfg, meshes["pod"]
        )
        assert spec == sharding.P(None, None, "model", None)

    def test_small_kv_heads_replicated(self, meshes):
        cfg = get_config("yi_6b")  # kv=4 < 16
        spec = sharding.param_spec(
            ("blocks", "pos0", "attn", "wk"), (32, 4096, 4, 128), cfg, meshes["pod"]
        )
        assert spec == sharding.P(None, None, None, None)

    def test_norms_replicated(self, meshes):
        cfg = get_config("yi_6b")
        spec = sharding.param_spec(("blocks", "pos0", "norm1", "scale"), (32, 4096), cfg, meshes["pod"])
        assert spec == sharding.P(None, None)


class TestCacheSpecRules:
    """``tests/test_launch.py::TestCacheSpecRules`` on the port's rules,
    read off the port's per-block cache leaves (stack entry dropped)."""

    def test_seq_takes_model_when_kv_small(self, meshes):
        cfg = get_config("internlm2_20b")  # kv=8
        cache = zoo.abstract_cache(cfg, 128, 32768)
        specs = sharding.cache_pspecs(cfg, meshes["pod"], cache)
        assert specs["blocks"][0]["pos0"]["k"] == sharding.P("data", "model", None, None)

    def test_batch1_seq_takes_all_axes(self, meshes):
        cfg = get_config("jamba_v01_52b")
        cache = zoo.abstract_cache(cfg, 1, 524288)
        specs = sharding.cache_pspecs(cfg, meshes["pod"], cache)
        assert specs["blocks"][0]["pos4"]["k"][1] == ("data", "model")

    def test_quantized_cache_specs(self, meshes):
        cfg = get_config("deepseek_moe_16b").scaled(kv_quant=True)
        cache = zoo.abstract_cache(cfg, 128, 32768)
        specs = sharding.cache_pspecs(cfg, meshes["pod"], cache)
        assert specs["blocks"][0]["pos0"]["k_q"][0] == "data"
        assert specs["blocks"][0]["pos0"]["k_s"][0] == "data"


class TestMoEShardRule:
    """``tests/test_serving_opt.py::TestMoEShardRule`` on the port."""

    def test_auto_prefers_ep_when_divisible(self, meshes):
        cfg = get_config("deepseek_moe_16b")  # 64 experts, divisible by 16
        spec = sharding.param_spec(
            ("blocks", "pos0", "moe", "w_gate"), (28, 64, 2048, 1408), cfg, meshes["pod"]
        )
        assert spec[1] == "model"  # experts dim sharded (EP)

    def test_auto_falls_back_to_tp(self, meshes):
        cfg = get_config("mixtral_8x7b")  # 8 experts, not divisible by 16
        spec = sharding.param_spec(
            ("blocks", "pos0", "moe", "w_gate"), (32, 8, 4096, 14336), cfg, meshes["pod"]
        )
        assert spec[1] is None and spec[3] == "model"  # ff sharded (TP)


class TestAnalyticModel:
    """``tests/test_launch.py::TestAnalyticModel`` on the port's copy, and
    the copy's numbers equal the reference's on every cell."""

    def test_dense_train_flops_match_6nd(self):
        cfg = get_config("yi_6b")
        shape = shape_by_name("train_4k")
        n = 6_000_000_000
        flops = analytic.step_flops(cfg, shape, n)
        base = 8 * n * shape.global_batch * shape.seq_len
        assert base < flops < 2 * base

    def test_kv_quant_halves_cache_bytes(self):
        cfg = get_config("yi_6b")
        shape = shape_by_name("decode_32k")
        full = analytic._cache_bytes_total(cfg, shape)
        quant = analytic._cache_bytes_total(cfg.scaled(kv_quant=True), shape)
        assert quant < 0.55 * full

    def test_window_caps_attention(self):
        gem = get_config("gemma3_27b")
        f_local = analytic._attn_layer_flops_fwd(gem, 32768, 32768, True, 1024)
        f_full = analytic._attn_layer_flops_fwd(gem, 32768, 32768, True, None)
        assert f_local < 0.1 * f_full

    @pytest.mark.parametrize("arch", ARCHITECTURES)
    def test_records_equal_the_reference(self, arch):
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        for shape in SHAPES:
            got = analytic.analytic_record(cfg, shape, 10**9, 10**8, 256, 8)
            want = ref_analytic.analytic_record(rcfg, shape, 10**9, 10**8, 256, 8)
            assert got == want


class TestMeshHelpers:
    def test_data_axes(self, meshes):
        assert mesh_lib.data_axes(meshes["pod"]) == ("data",)
        assert mesh_lib.data_axes(meshes["multipod"]) == ("pod", "data")

    def test_sizes(self, meshes):
        assert mesh_lib.model_axis_size(meshes["pod"]) == 16
        assert mesh_lib.data_parallel_size(meshes["pod"]) == 16
        assert mesh_lib.data_parallel_size(meshes["multipod"]) == 32
        assert tuple(meshes["pod"].get_coordinate()) == (0, 0)


class TestCollectiveStats:
    """Hand counts on known redistributes (16 ranks on each mesh axis)."""

    def _dt(self, mesh, local, placements, shape):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                                  stride=sharding._contiguous_stride(shape))

    def test_gather_reduce_and_scatter(self, meshes):
        from torch.distributed.tensor import Partial, Replicate, Shard

        mesh = meshes["pod"]
        x = self._dt(mesh, torch.zeros(4, 8), (Shard(0), Replicate()), (64, 8))
        g = self._dt(mesh, torch.zeros(64, 8), (Partial(), Replicate()), (64, 8))
        with hlo_analysis.CollectiveMode() as mode:
            x.redistribute(mesh, (Replicate(), Replicate()))
            g.redistribute(mesh, (Replicate(), Replicate()))
            g.redistribute(mesh, (Shard(0), Replicate()))
        stats = hlo_analysis.collective_stats(mode)
        assert stats.counts == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1}
        assert stats.bytes_by_kind == {
            "all-reduce": 2 * 64 * 8 * 4,      # twice the operand
            "all-gather": 64 * 8 * 4,          # the gathered result
            "reduce-scatter": 64 * 8 * 4,      # the operand
        }
        assert stats.total_bytes == 4 * 64 * 8 * 4
        assert sum(mode.get_comm_counts().values()) == 3

    def test_roofline_terms_on_h100_constants(self):
        t = hlo_analysis.roofline(
            flops_per_chip=989e12, bytes_per_chip=3.35e12,
            collective_bytes_per_chip=450e9, model_flops=989e12 * 256, chips=256,
        )
        assert abs(t.compute_s - 1.0) < 1e-9
        assert abs(t.memory_s - 1.0) < 1e-9
        assert abs(t.collective_s - 1.0) < 1e-9
        assert t.mfu == pytest.approx(1.0)
        assert np.isclose(t.step_time_s, 1.0)


@pytest.mark.parametrize(
    "heads,kv_heads,model,even",
    [(12, 4, 3, False), (12, 4, 2, True), (16, 2, 4, True)],
    ids=["h12kv4_model3_uneven", "h12kv4_model2", "h16kv2_model4_one_group"],
)
def test_attention_local_heads_read_their_kv_heads(meshes, heads, kv_heads, model, even):
    """Query heads sharded over the model axis with the KV heads whole:
    rank 0's heads read global KV head h // group, equal to the unsharded
    attention's heads; a slice whose heads do not cover their KV groups
    evenly (12 heads, 4 KV heads on 3 ranks: rank 0 holds heads 0-3 of
    groups 0, 0, 0, 1) raises instead."""

    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models import attention

    mesh = mesh_lib.make_debug_mesh(1, model, device_type="cpu")
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, heads, 8, generator=g)
    k = torch.randn(2, 5, kv_heads, 8, generator=g)
    v = torch.randn(2, 5, kv_heads, 8, generator=g)
    hl = heads // model
    dq = DTensor.from_local(
        q[:, :, :hl].contiguous(), mesh, [Replicate(), Shard(2)], run_check=False,
        shape=q.shape, stride=q.stride(),
    )
    dk, dv = (DTensor.from_local(t, mesh, [Replicate(), Replicate()], run_check=False) for t in (k, v))
    if not even:
        with pytest.raises(NotImplementedError, match="KV groups"):
            attention.chunked_attention(dq, dk, dv, causal=True)
        return
    out = attention.chunked_attention(dq, dk, dv, causal=True)
    want = attention.chunked_attention(q, k, v, causal=True)[:, :, :hl]
    assert torch.equal(out.to_local(), want)


# ---------------------------------------------------------------------- #
# the sharded steps in gloo worlds of 2 and 4
# ---------------------------------------------------------------------- #

FAMILIES = ("yi_6b", "deepseek_moe_16b", "mamba2_2_7b", "whisper_medium")
MESHES = {"data2": (2, (2, 1)), "model2": (2, (1, 2)), "data2xmodel2": (4, (2, 2))}
SPAWN_TIMEOUT_S = 240
TOL = 1e-5


def _spmd_job(mesh_shape):
    """Every family's smoke config in f32 on a (data, model) mesh of this
    world: the sharded train step (microbatches 1 and 4, FSDP gradient
    shardings, and with ``seq_shard``) against the unsharded one; the
    gradient reductions over the data axis; prefill and greedy decode."""

    t0 = time.perf_counter()
    from repro_torch.launch import hlo_analysis, sharding, steps
    from repro_torch.optim.optimizer import AdamWState

    mesh = mesh_lib.make_debug_mesh(*mesh_shape, device_type="cpu")
    data_groups = hlo_analysis.group_names(mesh, ["data"])
    # Adam's first step is g / (|g| + eps): eps 1e-3 bounds how far a
    # rounding difference in a near-zero gradient can move the update
    opt = AdamW(warmup_steps=1, eps=1e-3)
    out = {}
    for arch in FAMILIES:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        params = zoo.init(cfg, device="cpu", seed=0)
        ost = opt.init(params)
        g = torch.Generator().manual_seed(1)
        B, S = 16, 16
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        if cfg.family == "encdec":
            batch["frame_embeds"] = torch.randn(
                B, cfg.encoder.num_frames, cfg.d_model, generator=g
            )
        zs = sharding.named(mesh, sharding.zero1_pspecs(cfg, mesh, params))
        dp = sharding.distribute(params, sharding.named(mesh, sharding.params_pspecs(cfg, mesh, params)))
        do = AdamWState(step=ost.step, mu=sharding.distribute(ost.mu, zs), nu=sharding.distribute(ost.nu, zs))
        db = sharding.distribute(batch, sharding.named(mesh, sharding.batch_pspecs(cfg, mesh, batch)))
        row = {}
        for k in (1, 4):
            ref_p, _, ref_m = steps.make_train_step(cfg, opt, microbatches=k)(params, ost, batch)
            for seq in (False, True) if k == 4 else (False,):
                fn = steps.make_train_step(
                    cfg, opt, microbatches=k, mesh=mesh, grad_shardings=zs, seq_shard=seq
                )
                with hlo_analysis.CollectiveMode() as mode:
                    new_p, _, m = fn(dp, do, db)
                data = hlo_analysis.collective_stats(mode, data_groups).counts
                row[(k, seq)] = {
                    "loss": abs(float(m["loss"].full_tensor()) - float(ref_m["loss"])),
                    "grad_norm": abs(float(m["grad_norm"].full_tensor()) - float(ref_m["grad_norm"])),
                    "params": max(
                        float((a.full_tensor() - b).abs().max())
                        for a, b in zip(tree_lib.leaves(new_p), tree_lib.leaves(ref_p))
                    ),
                    "reductions": data.get("all-reduce", 0) + data.get("reduce-scatter", 0),
                    "counts": hlo_analysis.collective_stats(mode).counts,
                }
        row["serve"] = _greedy_pair(cfg, params, dp, mesh)
        out[arch] = row
    out["pod_split"] = _pod_split_is_the_reshape(mesh_shape)
    out["seconds"] = time.perf_counter() - t0
    return out


def _pod_split_is_the_reshape(mesh_shape):
    """The microbatch split over two data axes ("pod", "data") of a mesh of
    this world's ranks: each microbatch the reshape's rows, split over both
    axes, at 2 and 4 microbatches (1 is whole)."""

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import sharding
    from repro_torch.launch.steps import _microbatched

    world = mesh_shape[0] * mesh_shape[1]
    mesh = init_device_mesh("cpu", (2, world // 2, 1), mesh_dim_names=("pod", "data", "model"))
    x = torch.arange(16 * 3, dtype=torch.int32).reshape(16, 3)
    dx = sharding.distribute(x, sharding.NamedSharding(mesh, sharding.P(("pod", "data"), None)))
    ok = True
    for k in (2, 4):
        got = _microbatched(dx, k, mesh)
        ok &= tuple(got.placements[:2]) == (Shard(1), Shard(1)) or (16 // k) % world != 0
        ok &= torch.equal(got.full_tensor(), x.reshape(k, 16 // k, 3))
    return bool(ok)


def _greedy_pair(cfg, params, dp, mesh, B=4, S=8, N=4):
    """(unsharded, sharded) greedy tokens of a prefill and N-1 decode steps."""

    from repro_torch.launch import sharding, steps

    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.randn(B, cfg.encoder.num_frames, cfg.d_model, generator=g)
    pre, dec = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    tok_sh = sharding.named(mesh, sharding.batch_pspecs(cfg, mesh, {"t": torch.zeros(B, 1)}))["t"]

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def gen(p, b, c, place):
        logits, c = pre(p, b, c)
        nxt = torch.argmax(whole(logits)[:, -1, :], -1).to(torch.int32)[:, None]
        out = [nxt]
        for t in range(N - 1):
            nxt, c = dec(p, place(nxt), c, S + t)
            out.append(whole(nxt))
        return torch.cat(out, 1)

    ref = gen(params, batch, zoo.init_cache(cfg, B, S + N, device="cpu"), lambda t: t)
    cache = zoo.init_cache(cfg, B, S + N, device="cpu")
    dc = sharding.distribute(cache, sharding.named(mesh, sharding.cache_pspecs(cfg, mesh, cache)))
    db = sharding.distribute(batch, sharding.named(mesh, sharding.batch_pspecs(cfg, mesh, batch)))
    got = gen(dp, db, dc, lambda t: sharding.distribute(whole(t), tok_sh))
    return ref.tolist(), got.tolist()


def _spmd_worker(rank, world, init_file, mesh_shape, results):
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(1)
        import torch.distributed as dist

        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world
        )
        try:
            results.put((rank, "ok", _spmd_job(mesh_shape)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


def _spawn_all(tmp_path):
    """Every rank's result of ``_spmd_job`` on every mesh of ``MESHES``,
    the worlds run side by side; each wait is bounded, and on the timeout
    the children are killed and the test fails."""

    ctx = multiprocessing.get_context("spawn")
    runs = {}
    for name, (world, shape) in MESHES.items():
        results = ctx.Queue()
        init_file = str(tmp_path / f"store_{name}")
        procs = [
            ctx.Process(target=_spmd_worker, args=(r, world, init_file, shape, results), daemon=True)
            for r in range(world)
        ]
        for p in procs:
            p.start()
        runs[name] = (world, results, procs, {})
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for name, (world, results, procs, got) in runs.items():
            while len(got) < world and time.monotonic() < deadline:
                try:
                    rank, status, payload = results.get(timeout=5.0)
                except queue_mod.Empty:
                    if not any(p.is_alive() for p in procs):
                        break
                    continue
                got[rank] = (status, payload)
        for _, (_, _, procs, _) in runs.items():
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for _, (_, _, procs, _) in runs.items():
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    out = {}
    for name, (world, _, _, got) in runs.items():
        errors = {r: v for r, (s, v) in got.items() if s == "error"}
        assert not errors, "\n".join(f"{name} rank {r}:\n{tb}" for r, tb in errors.items())
        assert sorted(got) == list(range(world)), (
            f"{name}: ranks {sorted(set(range(world)) - set(got))} gave no result "
            f"in {SPAWN_TIMEOUT_S} s"
        )
        out[name] = {r: v for r, (_, v) in got.items()}
    return out


def test_microbatch_split_over_two_data_axes(spmd_run):
    """``("pod", "data")`` meshes split each microbatch over both axes by
    one all-to-all, giving the reference's reshape."""

    _, per_rank = spmd_run
    assert all(res["pod_split"] for res in per_rank.values())


@pytest.fixture(scope="module")
def spmd_runs(tmp_path_factory):
    return _spawn_all(tmp_path_factory.mktemp("spmd"))


@pytest.fixture(params=sorted(MESHES))
def spmd_run(request, spmd_runs):
    return request.param, spmd_runs[request.param]


@pytest.mark.parametrize("arch", FAMILIES)
class TestShardedSteps:
    def test_train_step_matches_unsharded(self, arch, spmd_run):
        _, per_rank = spmd_run
        for rank, res in per_rank.items():
            for key in ((1, False), (4, False)):
                row = res[arch][key]
                assert row["loss"] <= TOL and row["grad_norm"] <= TOL, (rank, key, row)
                assert row["params"] <= TOL, (rank, key, row)

    def test_seq_shard_matches_unsharded(self, arch, spmd_run):
        _, per_rank = spmd_run
        for rank, res in per_rank.items():
            row = res[arch][(4, True)]
            assert max(row["loss"], row["grad_norm"], row["params"]) <= TOL, (rank, row)

    def test_one_gradient_reduction_per_step(self, arch, spmd_run):
        """The gradients of every microbatch add up unreduced: the data
        axis sees as many reductions at microbatches 4 as at 1."""

        name, per_rank = spmd_run
        for res in per_rank.values():
            n1, n4 = res[arch][(1, False)]["reductions"], res[arch][(4, False)]["reductions"]
            assert n1 == n4, (name, n1, n4)
            assert (n1 > 0) == name.startswith("data2"), (name, n1)

    def test_prefill_and_decode_greedy_tokens(self, arch, spmd_run):
        """Sharded prefill and greedy decode give the unsharded tokens."""

        _, per_rank = spmd_run
        for res in per_rank.values():
            ref, got = res[arch]["serve"]
            assert got == ref
