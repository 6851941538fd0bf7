"""The port's 5-axis composite train step against the JAX package on the
CPU (`tests/test_composite.py` ported).

The port runs in one spawn of 8 gloo ranks (they import torch, numpy and
the port only; the weights come from the JAX package's
`init_composite_params` through `convert.composite_params_from_jax`, the
tokens from numpy). Every rank runs every case below on a mesh over all
8 ranks; the parent gathers each leaf's blocks by the leaf's pytree path,
checks that the ranks holding the same block hold the same bits (a
replicated leaf stays bit-equal), and compares the global tree with the
JAX package's step on the conftest's 8-device CPU mesh:

  * the six factorisations of `tests/test_composite.py`, capacity 4.0
    (nothing drops), against the JAX single-device step, which that
    test holds every factorisation to;
  * `remat=True` and `sp_strategy="alltoall"`, likewise;
  * `n_micro` 4 and 1 at (1, 2, 2, 2, 1), and 8 at (2, 2, 1, 1, 2) (the
    JAX test's (1, 2, 1, 1, 1) uses 2 of its 8 devices; a mesh here holds
    every rank): with nothing dropped the microbatch count does not move
    the numbers, so the reference is the same single-device step;
  * the overflow cases at the JAX test's tight capacity 1.0: over the
    model axes only, (1, 2, 2, 1, 2), the port equals the JAX
    single-device step; at (2, 1, 1, 2, 2) the port equals the JAX step
    at the same factorisation (the capacity is a shard's), and run twice
    it repeats bit for bit, as it does at (4, 1, 1, 2, 1); at capacity
    0.5 and (4, 1, 1, 2, 1) the port departs from the single-device step,
    as the JAX package documents.

The factorisation and the error messages are pure Python and are checked
here in the parent. Tolerances are the JAX test's: loss within 1e-4,
leaves rtol 2e-4, atol 2e-5 (remat: rtol 2e-3, atol 2e-4)."""
import json
import multiprocessing
import os
import socket
import traceback
import types

import numpy as np
import pytest
import torch

WORLD = 8
RANK_TIMEOUT_S = 150
AXES = ("dp", "pp", "tp", "sp", "ep")
CFG = dict(vocab=64, d_model=32, n_heads=4, d_head=8, d_ff=64, n_experts=4,
           d_expert_ff=32, n_layers=2, seq_len=16, batch=16, n_micro=2,
           lr=0.1, capacity_factor=4.0)
TIGHT = dict(capacity_factor=1.0)
LOOSE = dict(rtol=2e-4, atol=2e-5)
FACTORISATIONS = [(8, 1, 1, 1, 1), (1, 2, 2, 2, 1), (2, 1, 2, 1, 2),
                  (1, 2, 1, 2, 2), (2, 2, 2, 1, 1), (1, 1, 2, 2, 2)]
# (tag, mesh sizes, config changes)
CASES = ([("f_%d%d%d%d%d" % s, s, {}) for s in FACTORISATIONS] + [
    ("remat", (2, 1, 2, 1, 2), dict(remat=True)),
    ("alltoall", (2, 1, 1, 2, 2), dict(sp_strategy="alltoall")),
    ("micro4", (1, 2, 2, 2, 1), dict(n_micro=4)),
    ("micro1", (1, 2, 2, 2, 1), dict(n_micro=1)),
    ("micro8", (2, 2, 1, 1, 2), dict(n_micro=8)),
    ("tight_model", (1, 2, 2, 1, 2), TIGHT),
    ("tight_dp_sp", (2, 1, 1, 2, 2), TIGHT),
    ("tight_dp_sp_again", (2, 1, 1, 2, 2), TIGHT),
    ("tight_dp4", (4, 1, 1, 2, 1), TIGHT),
    ("tight_dp4_again", (4, 1, 1, 2, 1), TIGHT),
    ("half_dp4", (4, 1, 1, 2, 1), dict(capacity_factor=0.5))])


def _keystr(path):
    """A pytree path as `jax.tree_util.keystr` writes a dict path."""
    return "".join(f"['{k}']" for k in path)


def _problem():
    """(the JAX init's parameters as {keystr: numpy}, tokens, targets)."""
    import jax
    from mxnet_tpu.parallel.composite import (CompositeConfig,
                                              init_composite_params)
    params = init_composite_params(jax.random.PRNGKey(0),
                                   CompositeConfig(**CFG))
    flat = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(params)}
    rs = np.random.RandomState(0)
    shape = (CFG["batch"], CFG["seq_len"])
    return (flat, rs.randint(0, CFG["vocab"], shape).astype(np.int32),
            rs.randint(0, CFG["vocab"], shape).astype(np.int32))


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        path = [k.strip("'") for k in key.strip("[]").split("][")]
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------
def _rank_main(rank, port, in_path, out_dir):
    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore
    from mxnet_tpu_torch.parallel import composite as tc
    path = os.path.join(out_dir, f"rank{rank}")
    res, errors = {}, {}
    try:
        data = dict(np.load(in_path))
        tokens = torch.from_numpy(data.pop("tokens"))
        targets = torch.from_numpy(data.pop("targets"))
        tree = _unflatten(data)
        kvstore.init_distributed(f"127.0.0.1:{port}", WORLD, rank,
                                 device="cpu")
        meshes = {}
        try:
            for tag, sizes, change in CASES:
                try:
                    if sizes not in meshes:
                        meshes[sizes] = mx.parallel.make_mesh(
                            dict(zip(AXES, sizes)))
                    mesh = meshes[sizes]
                    cfg = tc.CompositeConfig(**{**CFG, **change})
                    step, shard, data_sh = tc.make_composite_train_step(
                        mesh, cfg)
                    params = shard(mx.convert.composite_params_from_jax(
                        tree, device="cpu"))
                    params, loss = step(params, data_sh.place(tokens),
                                        data_sh.place(targets))
                    res[f"{tag}|loss"] = np.array(float(loss))
                    res[f"{tag}|coords"] = np.array(
                        [mesh.axis_index(a) for a in AXES])
                    for p, v in tc._leaves_with_paths(params):
                        res[f"{tag}|{_keystr(p)}"] = v.numpy()
                except Exception:
                    errors[tag] = traceback.format_exc()
        finally:
            kvstore.reset_distributed()
        res["errors"] = np.array(json.dumps(errors))
        np.savez(path + ".npz", **res)
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def _jax_step(params, tokens, targets, sizes, change):
    """The JAX step on the first prod(sizes) CPU devices: ({keystr:
    numpy}, loss)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from mxnet_tpu.parallel.composite import (CompositeConfig,
                                              make_composite_train_step)
    devs = np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    step, shard, data_sh = make_composite_train_step(
        Mesh(devs, AXES), CompositeConfig(**{**CFG, **change}))
    tree = jax.tree_util.tree_map(jnp.asarray, _unflatten(params))
    new_p, loss = step(shard(tree), jax.device_put(tokens, data_sh),
                       jax.device_put(targets, data_sh))
    return ({jax.tree_util.keystr(p): np.asarray(v)
             for p, v in jax.tree_util.tree_leaves_with_path(new_p)},
            float(loss))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the global trees {tag: ({keystr: numpy}, loss)}, the JAX
    references, the ranks' errors, whether every replicated block was
    bit-equal over the ranks holding it)."""
    from mxnet_tpu.parallel.composite import composite_param_specs
    import jax
    out_dir = str(tmp_path_factory.mktemp("composite_ranks"))
    params, tokens, targets = _problem()
    in_path = os.path.join(out_dir, "problem.npz")
    np.savez(in_path, tokens=tokens, targets=targets, **params)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, in_path, out_dir))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    one = (1, 1, 1, 1, 1)
    refs = {"single": _jax_step(params, tokens, targets, one, {}),
            "single_tight": _jax_step(params, tokens, targets, one, TIGHT),
            "tight_dp_sp": _jax_step(params, tokens, targets,
                                     (2, 1, 1, 2, 2), TIGHT),
            "single_half": _jax_step(params, tokens, targets, one,
                                     dict(capacity_factor=0.5))}
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errs = {f: open(os.path.join(out_dir, f)).read()
            for f in os.listdir(out_dir) if f.endswith(".err")}
    assert not hung and not errs, (len(hung), errs)
    res = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
           for r in range(WORLD)]
    errors = {}
    for r in res:
        errors.update(json.loads(str(r["errors"])))
    specs = {jax.tree_util.keystr(p): tuple(s) for p, s in
             jax.tree_util.tree_leaves_with_path(
                 composite_param_specs(), is_leaf=lambda x: isinstance(
                     x, jax.sharding.PartitionSpec))}
    trees, unequal = {}, []
    for tag, sizes, _ in CASES:
        if tag in errors:
            continue
        shape = dict(zip(AXES, sizes))
        tree = {}
        for key, spec in specs.items():
            blocks = {}
            for r in res:
                coords = dict(zip(AXES, r[f"{tag}|coords"]))
                at = tuple(int(coords[a]) if a else 0 for a in spec)
                block = r[f"{tag}|{key}"]
                if at in blocks and not np.array_equal(blocks[at], block):
                    unequal.append((tag, key, at))
                blocks.setdefault(at, block)
            full = np.zeros([b * (shape[a] if a else 1) for b, a in zip(
                next(iter(blocks.values())).shape,
                spec + (None,) * 8)], np.float32)
            for at, block in blocks.items():
                idx = tuple(slice(i * n, (i + 1) * n) for i, n in
                            zip(at, block.shape))
                full[idx] = block
            tree[key] = full
        losses = {float(r[f"{tag}|loss"]) for r in res}
        trees[tag] = (tree, losses)
    return trees, refs, errors, unequal


def _assert_matches(got, want, tol=LOOSE, loss_atol=1e-4):
    tree, losses = got
    ref, ref_loss = want
    assert len(losses) == 1, f"the ranks' losses differ: {losses}"
    loss = next(iter(losses))
    assert abs(loss - ref_loss) < loss_atol, (loss, ref_loss)
    assert set(tree) == set(ref)
    for name, ref_v in ref.items():
        np.testing.assert_allclose(tree[name], ref_v, err_msg=name, **tol)


def _case(ranks, tag):
    trees, _, errors, _ = ranks
    assert tag not in errors, errors[tag]
    return trees[tag]


def test_replicated_blocks_bit_equal_on_every_rank(ranks):
    """Every block that several ranks hold (a leaf replicated over tp,
    ep, the data axes, or pp for embed / lm_head) holds the same bits on
    each after a step."""
    trees, _, errors, unequal = ranks
    assert not errors, errors
    assert not unequal, unequal[:10]
    assert len(trees) == len(CASES)


@pytest.mark.parametrize("sizes", FACTORISATIONS,
                         ids=lambda s: "dp%d_pp%d_tp%d_sp%d_ep%d" % s)
def test_composite_matches_single_device(ranks, sizes):
    _assert_matches(_case(ranks, "f_%d%d%d%d%d" % sizes), ranks[1]["single"])


def test_composite_remat_matches(ranks):
    """remat=True (a checkpoint a layer, the recompute issuing the
    layer's collectives again) changes memory, not math."""
    tree, losses = _case(ranks, "remat")
    ref, ref_loss = ranks[1]["single"]
    assert len(losses) == 1
    assert np.isclose(next(iter(losses)), ref_loss, rtol=1e-4)
    for name, ref_v in ref.items():
        np.testing.assert_allclose(tree[name], ref_v, rtol=2e-3, atol=2e-4,
                                   err_msg=name)


def test_composite_alltoall_sp_matches_single_device(ranks):
    _assert_matches(_case(ranks, "alltoall"), ranks[1]["single"])


@pytest.mark.parametrize("tag", ["micro4", "micro1", "micro8"])
def test_pp_microbatch_counts(ranks, tag):
    """GPipe with more, fewer and many more microbatches than stages."""
    _assert_matches(_case(ranks, tag), ranks[1]["single"])


def test_moe_overflow_model_axes_still_exact(ranks):
    _assert_matches(_case(ranks, "tight_model"), ranks[1]["single_tight"])


def test_moe_overflow_matches_jax_at_the_same_factorisation(ranks):
    """With a tight capacity the drops follow the dp / sp shard: the port
    at (2, 1, 1, 2, 2) equals the JAX package at (2, 1, 1, 2, 2)."""
    _assert_matches(_case(ranks, "tight_dp_sp"), ranks[1]["tight_dp_sp"])


@pytest.mark.parametrize("tag", ["tight_dp_sp", "tight_dp4"])
def test_moe_overflow_deterministic_per_factorisation(ranks, tag):
    tree1, l1 = _case(ranks, tag)
    tree2, l2 = _case(ranks, tag + "_again")
    assert l1 == l2 and all(np.isfinite(list(l1)))
    for name in tree1:
        np.testing.assert_array_equal(tree1[name], tree2[name],
                                      err_msg=name)


def test_moe_overflow_dp_factorisation_diverges_as_documented(ranks):
    _, losses = _case(ranks, "half_dp4")
    _, ref_loss = ranks[1]["single_half"]
    loss = next(iter(losses))
    assert np.isfinite(loss) and np.isfinite(ref_loss)
    assert abs(loss - ref_loss) > 1e-7


# ---------------------------------------------------------------------------
# pure Python: the factorisation and the errors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,priority,n_layers", [
    (8, None, None), (16, None, None), (12, None, None), (6, None, None),
    (1, None, None), (4, ("pp", "dp", "tp", "sp", "ep"), 3),
    (4, ("pp", "dp", "tp", "sp", "ep"), 4), (8, ("ep", "pp", "sp", "tp",
                                                 "dp"), 2)])
def test_factorisation_matches_jax(monkeypatch, n, priority, n_layers):
    """make_composite_mesh deals the prime factors as the JAX package
    does. Both packages' meshes are stand-ins here that keep the sizes
    (16 devices do not fit the CPU mesh)."""
    from mxnet_tpu.parallel import composite as jc
    from mxnet_tpu_torch.parallel import composite as tc
    monkeypatch.setattr(tc, "make_mesh", lambda axes, devices: axes)
    monkeypatch.setattr(jc, "Mesh", lambda devs, axes: dict(
        zip(axes, devs.shape)))
    kw = {} if priority is None else dict(priority=priority)
    got = tc.make_composite_mesh(n, n_layers=n_layers, **kw)
    want = jc.make_composite_mesh(n, n_layers=n_layers,
                                  devices=list(range(n)), **kw)
    assert got == want and tuple(got) == AXES
    assert int(np.prod(list(got.values()))) == n


def _stand_in(sizes):
    return types.SimpleNamespace(shape=dict(zip(AXES, sizes)))


def test_train_step_rejects_bad_factorisation_with_clear_error():
    """The JAX messages, word for word where its test matches them."""
    from mxnet_tpu_torch.parallel.composite import (
        CompositeConfig, make_composite_train_step)
    cfg = CompositeConfig(**CFG)
    with pytest.raises(ValueError, match="n_layers.*pp.*n_layers="):
        make_composite_train_step(_stand_in((1, 2, 1, 1, 1)),
                                  cfg._replace(n_layers=3))
    with pytest.raises(ValueError, match="batch.*dp\\*n_micro"):
        make_composite_train_step(_stand_in((2, 1, 1, 1, 1)),
                                  cfg._replace(batch=6, n_micro=4))
    with pytest.raises(ValueError, match="n_heads/tp=4 must be divisible "
                                         "by sp=8"):
        make_composite_train_step(_stand_in((1, 1, 1, 8, 1)),
                                  cfg._replace(sp_strategy="alltoall",
                                               seq_len=16))
    with pytest.raises(ValueError, match="unknown sp_strategy"):
        make_composite_train_step(_stand_in((1, 1, 1, 1, 1)),
                                  cfg._replace(sp_strategy="ulysses"))
    with pytest.raises(ValueError, match="n_experts=4 is not divisible by "
                                         "the mesh's ep=8"):
        make_composite_train_step(_stand_in((1, 1, 1, 1, 8)), cfg)


def test_entry_points_want_the_card_without_a_cpu_request():
    """init_composite_params and init_moe_params default to the card,
    and without one they raise instead of taking the CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import composite as tc
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    g = torch.Generator().manual_seed(0)
    with pytest.raises(mx.base.MXNetError):
        tc.init_composite_params(g, tc.CompositeConfig(**CFG))
    with pytest.raises(mx.base.MXNetError):
        mx.parallel.init_moe_params(g, 4, 8, 16)
    with pytest.raises(mx.base.MXNetError):
        mx.convert.composite_params_from_jax(_unflatten(_problem()[0]))
