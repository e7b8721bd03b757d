"""The port's production-mesh dry run and pipeline check, as subprocesses
(each makes its process rank 0 of a ``"fake"`` group of 512 ranks), held
against the reference's shardings: ``tests/test_dryrun_integration.py``'s
counterpart.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np

from repro.configs import get_config as ref_get_config
from repro.configs import shape_by_name as ref_shape_by_name
from repro.launch import sharding as ref_sharding
from repro.models import model_zoo as ref_zoo

ROOT = pathlib.Path(__file__).resolve().parents[1]
H100_HBM_BYTES = 80e9


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def _run(args, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True,
        timeout=timeout, env=env, cwd=str(ROOT),
    )


def _local_bytes(shapes, specs, mesh) -> int:
    """Bytes one rank holds of ``shapes`` under the reference's specs."""

    total = 0
    flat_specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )
    for leaf, spec in zip(jax.tree_util.tree_leaves(shapes), flat_specs):
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        n = 1
        for dim, ax in zip(leaf.shape, entries):
            names = () if ax is None else ((ax,) if isinstance(ax, str) else ax)
            n *= dim // int(np.prod([mesh.shape[a] for a in names] or [1]))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def test_dryrun_decode_cell_bytes_equal_the_reference_specs(tmp_path):
    proc = _run([
        "-m", "repro_torch.launch.dryrun", "--arch", "mamba2_2_7b",
        "--shape", "decode_32k", "--out", str(tmp_path),
    ])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "all requested cells lowered" in proc.stdout
    (record_file,) = tmp_path.glob("*.json")
    r = json.loads(record_file.read_text())
    assert (r["arch"], r["chips"], r["mesh"]) == ("mamba2-2.7b", 256, "pod16x16")

    # the arguments of the reference's decode lowering: params, the new
    # tokens (B, 1) and the cache, under the reference's specs
    cfg, shape = ref_get_config("mamba2_2_7b"), ref_shape_by_name("decode_32k")
    mesh = FakeMesh(data=16, model=16)
    params = ref_zoo.abstract_params(cfg)
    cache = ref_zoo.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    tokens = {"tokens": jax.ShapeDtypeStruct((shape.global_batch, 1), np.int32)}
    want = (
        _local_bytes(params, ref_sharding.params_pspecs(cfg, mesh, params), mesh)
        + _local_bytes(cache, ref_sharding.cache_pspecs(cfg, mesh, cache), mesh)
        + _local_bytes(tokens, ref_sharding.batch_pspecs(cfg, mesh, tokens), mesh)
    )
    mem = r["memory"]
    assert mem["argument_bytes"] == want
    assert 0 < mem["temp_peak_bytes"] and mem["peak_bytes"] < H100_HBM_BYTES
    assert r["n_total_params"] >= r["n_active_params"] > 0
    assert r["tokens_per_step"] == shape.global_batch
    assert r["cost"]["flops_per_chip"] > 0 and r["cost"]["bytes_per_chip"] > 0
    for key in ("roofline", "roofline_analytic"):
        assert r[key]["dominant"] in ("compute", "memory", "collective")
        assert r[key]["chips"] == 256
    coll = r["collectives"]
    assert coll["total_bytes"] == sum(coll["bytes_by_kind"].values()) > 0
    # the head-sharded mixer's out projection: one all-reduce a layer
    assert coll["counts"]["all-reduce"] >= cfg.num_layers
    assert r["hardware"]["peak_flops"] == 989e12


def test_dryrun_skip_record(tmp_path):
    """A full-attention arch at 500k tokens writes a skip record, exit 0."""

    proc = _run([
        "-m", "repro_torch.launch.dryrun", "--arch", "yi_6b",
        "--shape", "long_500k", "--out", str(tmp_path),
    ])
    assert proc.returncode == 0, proc.stderr[-3000:]
    (record_file,) = tmp_path.glob("*.json")
    r = json.loads(record_file.read_text())
    assert "skipped" in r and "full-attention" in r["skipped"]


def test_pp_lowering_one_handoff_per_step():
    """The sync-planned pipeline on the production mesh's 16-stage model
    dimension hands off once per microbatch step for 6 skip edges."""

    proc = _run(["-m", "repro_torch.runtime.pp_lowering"], timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "pp lowering: OK" in proc.stdout
    assert "hand-offs per microbatch step: 1 on 16 stages" in proc.stdout
    assert "naive one-per-dependence schedule: 21" in proc.stdout
