"""Tensor parallelism of quanto_tpu_torch against quanto_tpu's partitioned
kernel (TPU kernel #5) and its sharded Llama.

The port runs two ranks: gloo processes on the CPU, spawned once for the whole
file with a `file://` store under a temporary directory; their kernel
wrappers take their plain versions because the tensors lie on the CPU. JAX
runs the same shardings on `make_mesh({"tp": 2})` over two of the CPU
devices, its Pallas kernels in interpret mode. JAX is imported inside the
fixtures only, so that the spawned ranks, which import this module, do not
load it.

- Op level: `qbits_mm_partitioned` on each rank's part of a 512 x 2048 weight
  (group size 128) against JAX's `qbits_mm_partitioned`, column, row and
  replicated x float and int8 x x int4 and int2, at M = 16. A column shard's
  output equals the port's own unsharded output on those columns bit for
  bit; every case is within 1e-5 * max|ref| of JAX's (the TPU kernels sum
  group-factored, the plain versions dequantize first). A row shard off the
  Hopper envelope (256 x 768: K / 2 = 384 codes, 192 bytes a row) stays in
  the generic layout and agrees as closely with JAX, which replicates it.
- Model level: a tiny Llama (hidden 512, intermediate 1024, 8 heads, 4 kv
  heads, head dim 64, vocabulary 512, 2 layers, float32; every tp = 2 shard
  is on the Hopper envelope) in qint4 (lm_head included) and calibrated W4A8
  (lm_head excluded, float on every rank), its weights (and activation
  scales) carried over from the JAX model, frozen, then sharded: prefill
  logits, one decode step's logits and 6 greedy tokens over a float and a
  qint4 cache, against JAX's sharded model with `set_backend(pallas_qbits=
  True)` under the mesh, within 1e-4 * max|ref| with equal tokens, and
  against the port's unsharded model; both ranks' outputs are equal bit for
  bit, and `generate` on the ranks gives the same tokens.
  The continuous-batching engine on the sharded qint4 model sizes its
  cache from the local kv heads and gives the unsharded engine's tokens.
- Rules: `LLAMA_TP_RULES` names the modules JAX's rules name; the pad-free
  rule replicates; the refusals; `initialize` asked for a card where there
  is none, and its backend from the ranks' device identities (gathered
  identities patched in: separate cards, one card shared, the CPU).
- On two cards (marked `gpu`, skipped with fewer): two ranks over NCCL run
  the tiny qint4 Llama through the kernels and give the unsharded model's
  tokens, its logits within 1e-2 * max|ref| (bf16).
"""

import json
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

import quanto_tpu_torch as qtt
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from quanto_tpu_torch.models.loading import load_hf_state_dict
from quanto_tpu_torch.models.sampling import greedy
from quanto_tpu_torch.models.serve import decode, generate, make_cache, prefill
from quanto_tpu_torch.models.serving import BatchedEngine
from quanto_tpu_torch.ops.collectives import TPGroup, all_reduce
from quanto_tpu_torch.ops.cuda.qbits_mm_sharded import qbits_mm_partitioned
from quanto_tpu_torch.ops.qlinear import qlinear
from quanto_tpu_torch.parallel import LLAMA_TP_RULES, initialize, shard_model
from quanto_tpu_torch.parallel import distributed
from quanto_tpu_torch.parallel.sharding import _match_spec
from quanto_tpu_torch.tensor.activations import ActivationQBytesArray
from quanto_tpu_torch.tensor.weights import (
    WeightQBitsArray,
    WeightQBitsHopperArray,
    WeightQBitsRequantArray,
    shard_qbits,
)

WORLD = 2
OP_N, OP_K, OP_M, GS = 512, 2048, 16, 128
OFF_N, OFF_K = 256, 768
MODES = ("column", "row", "replicated")
OP_CASES = [(mode, xk, bits) for mode in MODES for xk in ("float", "int8") for bits in (4, 2)]
SX = 0.0123
TINY = dict(
    vocab_size=512,
    hidden_size=512,
    intermediate_size=1024,
    num_hidden_layers=2,
    num_attention_heads=8,
    num_key_value_heads=4,
)
B, T, NEW = 2, 16, 6
ARMS = {"qint4": dict(weights="qint4"), "w4a8": dict(weights="qint4", activations="qint8", exclude="lm_head")}
CACHES = ("float", "qint4")
CAL_BATCHES = [np.random.default_rng(20 + i).integers(0, TINY["vocab_size"], (B, T)) for i in range(2)]
IDS = np.random.default_rng(3).integers(0, TINY["vocab_size"], (B, T))
OP_TOL, MODEL_TOL = 1e-5, 1e-4


def close(out: torch.Tensor, ref, tol: float) -> None:
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape
    err, scale = np.max(np.abs(out - ref)), np.max(np.abs(ref))
    assert err <= tol * scale, (err, scale)


# --- inputs, made with numpy from seeds on both sides ---------------------------


def op_inputs(shape, bits):
    rng = np.random.default_rng(bits + shape[1])
    w = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((OP_M, shape[1])).astype(np.float32)
    xq = rng.integers(-127, 128, (OP_M, shape[1])).astype(np.int8)
    return w, x, xq


def port_qweight(w: np.ndarray, bits: int) -> WeightQBitsArray:
    qtype = qtt.qint4 if bits == 4 else qtt.qint2
    wt = torch.from_numpy(w)
    scale, shift = qtt.MaxOptimizer()(wt, qtype, axis=0, group_size=GS)
    return qtt.quantize_weight(wt, qtype, 0, scale, shift=shift, group_size=GS)


def port_x(x: np.ndarray, xq: np.ndarray, xk: str, cols=slice(None)):
    if xk == "float":
        return torch.from_numpy(x[:, cols].copy())
    return ActivationQBytesArray(torch.from_numpy(xq[:, cols].copy()), torch.tensor(SX), qtt.qint8, torch.float32)


def port_model(arm: str, d, group=None) -> LlamaForCausalLM:
    """The tiny Llama from JAX's state in `d`, quantized and frozen as `arm`,
    then sharded over `group`; without one, unsharded in the Hopper layout
    (the kernels' plain versions, as the shards run them)."""
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    state = dict(np.load(d / f"{arm}.npz"))
    if arm == "w4a8":
        qtt.quantize(model, **ARMS[arm])
        assert load_hf_state_dict(model, state) == {"missing": [], "unexpected": []}
        flags = json.loads((d / "flags.json").read_text())
        for name, m in qtt.named_qmodules(model):
            m.quantize_outputs = flags[name]
    else:
        assert load_hf_state_dict(model, state) == {"missing": [], "unexpected": []}
        qtt.quantize(model, **ARMS[arm])
    qtt.freeze(model)
    if group is not None:
        shard_model(model, group, LLAMA_TP_RULES)
    else:
        for m in model.modules():
            if isinstance(m, qtt.nn.QLinear):
                m.weight = WeightQBitsHopperArray.from_generic(m.weight)
    return model


# --- what each rank runs ----------------------------------------------------------


def run_model(model, kv: str) -> dict:
    """Prefill logits, the first decode step's logits and NEW greedy tokens over
    a `kv` cache, with the collectives they took; over a float cache also
    `generate`'s tokens."""
    ids = torch.from_numpy(IDS)
    calls, partial = all_reduce.calls, qbits_mm_partitioned.all_reduces
    with torch.no_grad():
        cache = make_cache(model, B, T + NEW, kv_quant=None if kv == "float" else kv)
        logits, cache = prefill(model, ids, cache)
        first = greedy(logits[:, -1])[:, None]
        step, cache = model(first, cache, T)
        second = greedy(step[:, -1])[:, None]
        rest, _ = decode(model, second, cache, T + 1, NEW - 2)
    out = {
        "prefill": logits, "step": step, "tokens": torch.cat([first, second, rest], dim=1),
        "all_reduces": all_reduce.calls - calls, "partitioned_all_reduces": qbits_mm_partitioned.all_reduces - partial,
    }
    if kv == "float":
        out["generate"] = generate(model, ids, NEW)[:, T:]
    return out


def run_engine(model) -> dict:
    """Two prompts of different lengths through the continuous-batching
    engine over a float cache: their tokens and the cache's kv heads."""
    engine = BatchedEngine(model, max_batch=B, max_len=T + NEW)
    rids = [engine.add(IDS[0], NEW), engine.add(IDS[1, : T // 2], NEW)]
    engine.run_to_completion()
    return {"tokens": [engine.result(rid) for rid in rids], "kv_heads": engine._cache[0][0].shape[2]}


def rank_ops(group) -> dict:
    """Every op-level case on this rank: its output, the port's unsharded
    output of the same inputs, its all_reduces and its part's layout."""
    r = group.rank
    out = {}
    cases = [(mode, xk, bits, (OP_N, OP_K)) for mode, xk, bits in OP_CASES]
    cases += [("row", xk, 4, (OFF_N, OFF_K)) for xk in ("float", "int8")]
    for mode, xk, bits, shape in cases:
        w, x, xq = op_inputs(shape, bits)
        qw = port_qweight(w, bits)
        part = shard_qbits(qw, mode, group)
        k = shape[1] // WORLD
        cols = slice(r * k, (r + 1) * k) if mode == "row" else slice(None)
        before = qbits_mm_partitioned.all_reduces
        y = qbits_mm_partitioned(port_x(x, xq, xk, cols), part)
        out[op_key(mode, xk, bits, shape)] = {
            "out": y, "all_reduces": qbits_mm_partitioned.all_reduces - before, "layout": type(part).__name__,
            "unsharded": qlinear(port_x(x, xq, xk), WeightQBitsHopperArray.from_generic(qw)),
        }
    return out


def op_key(mode, xk, bits, shape=(OP_N, OP_K)) -> str:
    return f"{mode}-{xk}-int{bits}-{shape[0]}x{shape[1]}"


def rank_main(rank: int, d) -> None:
    # One thread a rank: with two, MKL splits K across threads on the op shapes, which moves the last
    # bit of a float32 sum between an [M, N] product and its [M, N / 2] column shard.
    torch.set_num_threads(1)
    group = initialize(rank, WORLD, f"file://{d}/store", device="cpu")
    try:
        out = {"ops": rank_ops(group), "backend": group.backend}
        for arm in ARMS:
            model = port_model(arm, d, group)
            launches = qbits_mm_partitioned.launches
            out.update({f"{arm}-{kv}": run_model(model, kv) for kv in CACHES})
            out[f"{arm}-launches"] = qbits_mm_partitioned.launches - launches
            out[f"{arm}-heads"] = [(m.num_heads, m.num_kv_heads) for m in model.modules() if hasattr(m, "num_kv_heads")]
            if arm == "qint4":
                out["engine"] = run_engine(model)
            if rank == 0:
                model = port_model(arm, d)
                out.update({f"{arm}-{kv}-unsharded": run_model(model, kv) for kv in CACHES})
                if arm == "qint4":
                    out["engine-unsharded"] = run_engine(model)
        torch.save(out, d / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, *args, timeout: float = 600.0) -> None:
    """Start WORLD spawned ranks of `fn(rank, *args)`, wait for all of them;
    a rank that fails fails the call (and stops the others)."""
    ctx = mp.start_processes(fn, args=args, nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")


# --- JAX's side -------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ops():
    """JAX's `qbits_mm_partitioned` on each op case (int8 x: times its scale)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import quanto_tpu as qt
    from quanto_tpu.ops.pallas.qbits_mm_sharded import qbits_mm_partitioned as jax_partitioned
    from quanto_tpu.parallel import make_mesh
    from quanto_tpu.tensor.weights import WeightQBitsTpuArray

    mesh = make_mesh({"tp": 2}, devices=jax.devices()[:2])
    specs = {  # (k_shards, x, packed, scale_t/shift_t)
        "column": (1, P(), P("tp", None), P(None, "tp")),
        "row": (WORLD, P(None, "tp"), P(None, "tp"), P("tp", None)),
        "replicated": (1, P(), P(), P()),
    }
    refs, repack = {}, None
    cases = [(mode, xk, bits, (OP_N, OP_K)) for mode, xk, bits in OP_CASES]
    cases += [("replicated", xk, 4, (OFF_N, OFF_K)) for xk in ("float", "int8")]  # JAX replicates it
    for mode, xk, bits, shape in cases:
        w, x, xq = op_inputs(shape, bits)
        qtype = qt.qint4 if bits == 4 else qt.qint2
        wj = jnp.asarray(w)
        scale, shift = qt.MaxOptimizer()(wj, qtype, axis=0, group_size=GS)
        qw = qt.quantize_weight(wj, qtype, 0, scale, shift=shift, group_size=GS)
        ks, xs, ps, ss = specs[mode]
        tpu = WeightQBitsTpuArray.from_generic(qw, k_shards=ks)
        if shape == (OFF_N, OFF_K):
            repack = WeightQBitsTpuArray.from_generic(qw).repack(WORLD)
        put = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
        xa = jnp.asarray(x) if xk == "float" else jnp.asarray(xq)
        fn = jax.jit(lambda a, p, s, z: jax_partitioned(a, p, s, z, bits, GS, k_shards=ks, interpret=True))
        with mesh:
            y = np.asarray(fn(put(xa, xs), put(tpu._packed, ps), put(tpu._scale_t, ss), put(tpu._shift_t, ss)))
        if xk == "int8":
            y = y * np.float32(SX)
        refs[op_key("row" if shape == (OFF_N, OFF_K) else mode, xk, bits, shape)] = y
    assert repack is None  # JAX's block-local layout refuses this row shard: its shard_model replicates it
    return refs


def jax_run(model, mesh):
    """JAX's counterpart of `run_model`, each forward jitted under the mesh."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    from quanto_tpu.models.llama import init_kv_cache as jax_init_kv_cache

    graphdef, state = nnx.split(model)
    fwd = jax.jit(lambda st, ids, cache, pos: nnx.merge(graphdef, st)(ids, cache, pos))
    ids = jnp.asarray(IDS, jnp.int32)
    out = {}
    for kv in CACHES:
        with mesh:
            cache = jax_init_kv_cache(model.config, B, T + NEW, kv_quant=None if kv == "float" else kv)
            logits, cache = fwd(state, ids, cache, jnp.int32(0))
            toks = [jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]]
            step, cache = fwd(state, toks[0], cache, jnp.int32(T))
            toks.append(jnp.argmax(step[:, -1], -1).astype(jnp.int32)[:, None])
            for i in range(NEW - 2):
                nxt, cache = fwd(state, toks[-1], cache, jnp.int32(T + 1 + i))
                toks.append(jnp.argmax(nxt[:, -1], -1).astype(jnp.int32)[:, None])
        out[kv] = {"prefill": np.asarray(logits), "step": np.asarray(step),
                   "tokens": np.asarray(jnp.concatenate(toks, axis=1))}
    return out


@pytest.fixture(scope="module")
def jax_models():
    """The states the ranks load, and JAX's sharded model's outputs for each arm."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    import quanto_tpu as qt
    from quanto_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from quanto_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from quanto_tpu.models.loading import hf_state_dict
    from quanto_tpu.ops import config as jax_ops_config
    from quanto_tpu.parallel import LLAMA_TP_RULES as JAX_RULES
    from quanto_tpu.parallel import make_mesh
    from quanto_tpu.parallel import shard_model as jax_shard_model

    mesh = make_mesh({"tp": 2}, devices=jax.devices()[:2])
    states, flags, refs = {}, None, {}
    for arm, kw in ARMS.items():
        model = JaxLlama(JaxLlamaConfig(**TINY), rngs=nnx.Rngs(0))
        if arm == "qint4":
            states[arm] = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
        qt.quantize(model, **kw)
        if arm == "w4a8":
            qt.calibrate_jit(model, [jnp.asarray(b, jnp.int32) for b in CAL_BATCHES])
            flags = {n: m.quantize_outputs for n, m in qt.named_qmodules(model)}
            states[arm] = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
        jax_ops_config.set_backend(pallas_qbits=True)
        try:
            qt.freeze(model)
            jax_shard_model(model, mesh, JAX_RULES)
            refs[arm] = jax_run(model, mesh)
        finally:
            jax_ops_config.set_backend()
    return states, flags, refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_models):
    states, flags, _ = jax_models
    d = tmp_path_factory.mktemp("tp")
    for arm, state in states.items():
        np.savez(d / f"{arm}.npz", **state)
    (d / "flags.json").write_text(json.dumps(flags))
    run_ranks(rank_main, d)
    return [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]


# --- tests ------------------------------------------------------------------------


@pytest.mark.parametrize("mode,xk,bits", OP_CASES)
def test_partitioned_matches_jax(ranks, jax_ops, mode, xk, bits):
    key = op_key(mode, xk, bits)
    parts = [r["ops"][key] for r in ranks]
    assert all(p["layout"] == "WeightQBitsHopperArray" for p in parts)
    assert all(p["all_reduces"] == (mode == "row") for p in parts)
    if mode == "column":
        n = OP_N // WORLD
        for r, p in enumerate(parts):
            assert torch.equal(p["out"], p["unsharded"][:, r * n : (r + 1) * n])  # bit for bit
        got = torch.cat([p["out"] for p in parts], dim=1)
    else:
        got = parts[0]["out"]
        assert torch.equal(parts[1]["out"], got)
    assert got.dtype == torch.float32
    close(got, jax_ops[key], OP_TOL)
    close(got, parts[0]["unsharded"], OP_TOL)


@pytest.mark.parametrize("xk", ["float", "int8"])
def test_off_envelope_row_shard_stays_generic(ranks, jax_ops, xk):
    key = op_key("row", xk, 4, (OFF_N, OFF_K))
    parts = [r["ops"][key] for r in ranks]
    assert all(p["layout"] == "WeightQBitsArray" and p["all_reduces"] == 1 for p in parts)
    assert torch.equal(parts[0]["out"], parts[1]["out"])
    close(parts[0]["out"], jax_ops[key], OP_TOL)


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("kv", CACHES)
def test_tp_model_matches_jax(ranks, jax_models, arm, kv):
    ref = jax_models[2][arm][kv]
    got, other = (r[f"{arm}-{kv}"] for r in ranks)
    unsharded = ranks[0][f"{arm}-{kv}-unsharded"]
    for what in ("prefill", "step", "tokens"):
        assert torch.equal(got[what], other[what])  # the ranks agree bit for bit
    for what in ("prefill", "step"):
        close(got[what], ref[what], MODEL_TOL)
        close(got[what], unsharded[what].numpy(), MODEL_TOL)
    np.testing.assert_array_equal(got["tokens"].numpy(), ref["tokens"])
    assert torch.equal(got["tokens"], unsharded["tokens"])
    if kv == "float":
        assert torch.equal(got["generate"], got["tokens"])
    # Per forward: 2 layers x (o_proj + down_proj), the embedding, and the gathered head (qint4
    # only: W4A8's float lm_head stays whole on every rank). NEW forwards over the cache.
    assert got["partitioned_all_reduces"] == 4 * NEW
    assert got["all_reduces"] == (6 if arm == "qint4" else 5) * NEW
    assert ranks[0][f"{arm}-heads"] == [(4, 2)] * TINY["num_hidden_layers"]
    assert ranks[0][f"{arm}-launches"] == 0  # the CPU takes the plain versions: no kernel launched
    assert ranks[0]["backend"] == "gloo"


def test_tp_engine_matches_unsharded(ranks):
    got, other = (r["engine"] for r in ranks)
    assert got["kv_heads"] == TINY["num_key_value_heads"] // WORLD
    assert got["tokens"] == other["tokens"] == ranks[0]["engine-unsharded"]["tokens"]
    assert ranks[0]["engine-unsharded"]["kv_heads"] == TINY["num_key_value_heads"]


def test_rules_match_jax():
    from quanto_tpu.parallel import LLAMA_TP_RULES as JAX_RULES
    from quanto_tpu.parallel.sharding import _match_spec as jax_match_spec

    model = LlamaForCausalLM(LlamaConfig(**TINY), device="meta")
    names = [name for name, _ in model.named_modules()]
    matched = {name: _match_spec(name, LLAMA_TP_RULES) for name in names}
    assert matched == {name: (lambda s: None if s is None else tuple(s))(jax_match_spec(name, JAX_RULES))
                       for name in names}
    assert sum(spec is not None for spec in matched.values()) == 7 * TINY["num_hidden_layers"] + 2


def tiny_frozen(seed: int = 0, **quantize_kw) -> LlamaForCausalLM:
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu", generator=torch.Generator().manual_seed(seed))
    qtt.quantize(model, **(quantize_kw or dict(weights="qint4")))
    qtt.freeze(model)
    return model


def test_pad_free_rule_replicates():
    """Over 3 ranks no dimension of the tiny model divides: every part is the
    whole weight, the embedding stays whole, no collective runs (the group
    has no process group to run one), and rank 1 computes the unsharded
    model's logits."""
    group = TPGroup(rank=1, world_size=3, group=None, device=torch.device("cpu"))
    ids = torch.from_numpy(IDS)
    ref = tiny_frozen()
    model = tiny_frozen()
    shard_model(model, group)
    parts = [m.weight for m in model.modules() if isinstance(m, qtt.nn.QLinear)]
    wholes = [m.weight for m in ref.modules() if isinstance(m, qtt.nn.QLinear)]
    assert len(parts) == 7 * TINY["num_hidden_layers"] + 1
    assert all(p.shard.mode == "replicated" and p.shape == w.shape for p, w in zip(parts, wholes))
    assert model.model.embed_tokens.weight.shape[0] == TINY["vocab_size"] and model.tp is group
    calls = all_reduce.calls
    with torch.no_grad():
        close(model(ids)[0], ref(ids)[0].numpy(), 1e-6)
    assert all_reduce.calls == calls


def test_column_shard_slices_bias():
    group = TPGroup(rank=1, world_size=2, group=None, device=torch.device("cpu"))
    net = nn.Module()
    net.q_proj = nn.Linear(256, 256, bias=True, device="cpu")
    nn.init.normal_(net.q_proj.bias)
    qtt.quantize(net, weights="qint4")
    qtt.freeze(net)
    x = torch.randn((4, 256), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = net.q_proj(x)
        shard_model(net, group)
        out = net.q_proj(x)
    assert net.q_proj.weight.shard.mode == "column" and net.q_proj.bias.shape == (128,)
    close(out, ref[:, 128:].numpy(), 1e-6)


def test_refusals(tmp_path):
    group = TPGroup(rank=0, world_size=2, group=None, device=torch.device("cpu"))
    unfrozen = nn.Module()
    unfrozen.q_proj = nn.Linear(256, 256, bias=False, device="cpu")
    qtt.quantize(unfrozen, weights="qint4")
    with pytest.raises(NotImplementedError, match="not frozen"):
        shard_model(unfrozen, group)
    eight = nn.Module()
    eight.q_proj = nn.Linear(256, 256, bias=False, device="cpu")
    qtt.quantize(eight, weights="qint8")
    qtt.freeze(eight)
    with pytest.raises(NotImplementedError, match="WeightQBytesArray"):
        shard_model(eight, group)
    w, x, _ = op_inputs((OP_N, OP_K), 4)
    hop = WeightQBitsHopperArray.from_generic(port_qweight(w, 4))
    requant = WeightQBitsRequantArray.from_hopper(hop)
    with pytest.raises(NotImplementedError, match="requant"):
        shard_qbits(requant, "column", group)
    part = WeightQBitsRequantArray.from_hopper(shard_qbits(hop, "column", group))
    with pytest.raises(NotImplementedError, match="requant"):
        qbits_mm_partitioned(torch.from_numpy(x), part)
    with pytest.raises(ValueError, match="splits groups"):
        shard_qbits(port_qweight(op_inputs((128, 384), 4)[0], 4), "row", group)


def test_initialize_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize(0, 1, f"file://{tmp_path}/store")
    assert not dist.is_initialized()




BACKEND_CASES = {
    # Each rank sees only its own card, as "cuda:0" (a per-process CUDA_VISIBLE_DEVICES): two cards.
    "own-cards": ([("host", "GPU-a"), ("host", "GPU-b")], "nccl"),
    "own-hosts": ([("host-a", "GPU-a"), ("host-b", "GPU-b")], "nccl"),
    "one-card-shared": ([("host", "GPU-a"), ("host", "GPU-a")], "gloo"),
    "cpu": ([("host", "cpu"), ("host", "cpu")], "gloo"),
    "card-and-cpu": ([("host", "GPU-a"), ("host", "cpu")], "gloo"),
}


@pytest.mark.parametrize("case", list(BACKEND_CASES))
def test_initialize_backend_from_identities(monkeypatch, tmp_path, case):
    """`initialize` takes NCCL exactly when the gathered device identities are
    all cards and all distinct: the identities are patched into the gather of
    a one-rank group, and the NCCL group into `new_group`."""
    identities, want = BACKEND_CASES[case]
    nccl = object()
    monkeypatch.setattr(dist, "all_gather_object", lambda out, obj: out.__setitem__(slice(None), identities))
    monkeypatch.setattr(dist, "new_group", lambda backend: nccl if backend == "nccl" else None)
    group = initialize(0, 1, f"file://{tmp_path}/store", device="cpu")
    try:
        assert group.backend == want
        assert (group.group is nccl) == (want == "nccl")
    finally:
        dist.destroy_process_group()
    assert distributed.choose_backend(identities) == want
    assert distributed.device_identity(torch.device("cpu"))[1] == "cpu"


def rank_on_own_card(rank: int, d) -> None:
    """A rank of the two-card test: the tiny qint4 Llama on card `rank`,
    sharded over NCCL; rank 0 also runs it unsharded."""
    device = f"cuda:{rank}"
    group = initialize(rank, WORLD, f"file://{d}/store", device=device)
    try:
        out = {"backend": group.backend}
        for sharded in (True, False) if rank == 0 else (True,):
            model = LlamaForCausalLM(LlamaConfig(**TINY), device=device, generator=torch.Generator(device).manual_seed(0))
            qtt.quantize(model, weights="qint4")
            qtt.freeze(model)
            if sharded:
                shard_model(model, group)
            launches = qbits_mm_partitioned.launches
            ids = torch.from_numpy(IDS).to(device)
            with torch.no_grad():
                logits, cache = prefill(model, ids, make_cache(model, B, T + NEW))
                first = greedy(logits[:, -1])[:, None]
                rest, _ = decode(model, first, cache, T, NEW - 1)
            out["sharded" if sharded else "unsharded"] = {
                "prefill": logits.cpu(), "tokens": torch.cat([first, rest], dim=1).cpu(),
                "launches": qbits_mm_partitioned.launches - launches,
            }
        torch.save(out, d / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_tp_over_nccl_on_two_cards(tmp_path):
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA cards: the ranks take one each, over NCCL")
    run_ranks(rank_on_own_card, tmp_path)
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    assert [g["backend"] for g in got] == ["nccl"] * WORLD
    ref = got[0]["unsharded"]
    for g in got:
        assert torch.equal(g["sharded"]["tokens"], ref["tokens"])
        assert torch.equal(g["sharded"]["prefill"], got[0]["sharded"]["prefill"])
        # 7 linears a layer and the lm_head, per forward (the prefill and NEW - 1 decode steps).
        assert g["sharded"]["launches"] == (7 * TINY["num_hidden_layers"] + 1) * NEW
    close(got[0]["sharded"]["prefill"], ref["prefill"].numpy(), MODEL_TOL)
