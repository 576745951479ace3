"""Rank programs for the port's mesh tests: four gloo processes on the
CPU, spawned once per test module, run every case and hand numpy results
back to the parent (which holds them against the JAX package).  Nothing
here imports JAX: the ranks need only the port."""
import os
import pickle
import tempfile
import traceback

import numpy as np

WORLD = 4


def spawn(program: str, payload, directory: str):
    """Run ``program(rank, payload)`` on ``WORLD`` gloo ranks (a
    ``file://`` rendezvous in ``directory``: no fixed port, so test
    workers on one host never meet) -> rank 0's result."""
    import torch.multiprocessing as mp

    d = tempfile.mkdtemp(dir=directory)
    with open(os.path.join(d, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    mp.spawn(_entry, args=(program, d), nprocs=WORLD, join=True)
    with open(os.path.join(d, "result.pkl"), "rb") as f:
        return pickle.load(f)


def _entry(rank, program, d):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks, rendezvous_file

    torch.set_num_threads(1)
    init_ranks(rank, WORLD, rendezvous_file(d))
    with open(os.path.join(d, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    result = globals()[program](rank, payload)
    if rank == 0:
        with open(os.path.join(d, "result.pkl"), "wb") as f:
            pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def _each(cases, fn):
    """{case id: fn(case)}, a failing case recorded as its traceback."""
    import time

    out = {}
    for case in cases:
        t0 = time.perf_counter()
        try:
            out[case["id"]] = fn(case)
        except Exception:  # noqa: BLE001 — the parent's test reports it
            out[case["id"]] = {"error": traceback.format_exc()}
        out[case["id"]]["seconds"] = time.perf_counter() - t0
    return out


def _pl(placements):
    """Placements as plain tuples: ("Shard", dim), ("Replicate",), ..."""
    return [(type(p).__name__,) + ((p.dim,) if hasattr(p, "dim") else ())
            for p in placements]


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t
            ).detach().float().numpy()


# ---------------------------------------------------------------------------
# nn-level mesh regions
# ---------------------------------------------------------------------------


def mesh_ops(rank, payload):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh, staged_all_gather
    from repro_torch.models import get_model, nn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.convert import unstack_axes

    mesh = make_local_mesh(2, 2, device="cpu")
    arr = {k: torch.from_numpy(v) for k, v in payload["arrays"].items()}

    def leaf(name, spec):
        return shd.place(arr[name].clone().requires_grad_(True),
                         shd.NamedSharding(mesh, spec))

    def linear(case):
        col = case["mode"] == "column"
        w = leaf("w_col" if col else "w_row",
                 ("data", "model") if col else ("model", "data"))
        x = leaf("x", ("data", None, None))
        with nn.mesh_context(mesh):
            y = nn.linear_apply_tp({"w": w}, x, case["mode"], mesh, None,
                                   fsdp=case["fsdp"],
                                   seq_shard=case["seq_shard"])
            placements = _pl(y.placements)
            g = arr["gy_col" if col else "gy_row"]
            (y * nn.as_dtensor(g, mesh)).sum().full_tensor().backward()
        return {"y": _full(y), "dx": _full(x.grad), "dw": _full(w.grad),
                "placements": placements}

    def embedding(case):
        t = leaf("table", (None, "model"))
        ids = shd.place(arr["ids"], shd.NamedSharding(mesh, ("data", None)))
        with nn.mesh_context(mesh):
            y = nn.embedding_apply({"table": t}, ids, mesh=mesh)
            (y * nn.as_dtensor(arr["gy_emb"], mesh)).sum().full_tensor(
            ).backward()
        return {"y": _full(y), "dtable": _full(t.grad)}

    def loglik(case):
        lg = leaf("logits", ("data", None, "model"))
        tg = shd.place(arr["targets"], shd.NamedSharding(mesh, ("data", None)))
        with nn.mesh_context(mesh):
            ll = tfm._sharded_loglik(lg, tg, mesh, lg.shape[0])
            (ll * nn.as_dtensor(arr["gll"], mesh)).sum().full_tensor(
            ).backward()
        return {"ll": _full(ll), "dlogits": _full(lg.grad)}

    def shards(case):
        cfg = ModelConfig(**case["cfg"])
        params, axes = get_model(cfg).init(torch.Generator().manual_seed(0),
                                           cfg, device="cpu", with_axes=True)
        sh = shd.make_shardings(unstack_axes(axes, cfg), shd.TRAIN_RULES,
                                mesh)
        from repro_torch.training.optim import named_leaves

        out = {}
        for (path, p), (_, s) in zip(named_leaves(params), named_leaves(sh)):
            out[path] = (tuple(p.shape), s.spec,
                         tuple(shd.place(p, s).to_local().shape))
        return {"leaves": out}

    def staged(case):
        x = torch.full((2, 3), float(rank + 1))
        group = dist.group.WORLD.group_name
        want = funcol.wait_tensor(torch.ops._c10d_functional
                                  .all_gather_into_tensor(x, WORLD, group))
        got = staged_all_gather(x, WORLD, group)
        return {"equal": bool(torch.equal(got, want)),
                "rows": got[:, 0].tolist()}

    programs = {"linear": linear, "embedding": embedding, "loglik": loglik,
                "shards": shards, "staged": staged}
    return _each(payload["cases"], lambda c: programs[c["kind"]](c))


# ---------------------------------------------------------------------------
# Sharded train steps
# ---------------------------------------------------------------------------


def train_steps(rank, payload):
    import torch

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import get_model, nn
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.training import optim, train

    def run(case):
        cfg = ModelConfig(**case["cfg"])
        api = get_model(cfg)
        mesh = make_local_mesh(*case["mesh"], device="cpu")
        opt = optim.OptimizerConfig(**case["opt"])
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in case["batches"]]
        tcfg = train.TrainConfig(global_batch=batches[0]["tokens"].shape[0],
                                 seq_len=batches[0]["tokens"].shape[1],
                                 microbatches=case["microbatches"],
                                 optimizer=opt)
        params = params_from_numpy(case["weights"], cfg, "cpu")
        _, axes = api.init(torch.Generator(), cfg, device="meta",
                           with_axes=True)
        state_sh = train.state_shardings(axes, opt, mesh, cfg=cfg)
        batch_sh = train.batch_shardings(cfg, mesh)
        state = train.place_state(
            {"params": params, "opt": optim.adamw_init(params, opt)},
            state_sh)
        out = {"placements": {}}
        for path, p in optim.named_leaves(state["params"]):
            out["placements"][path] = _pl(p.placements)
        # the first batch's loss and gradient, as the step computes them
        b0 = train._place_tree(batches[0], batch_sh)
        leaves = optim.tree_leaves(state["params"])
        with nn.mesh_context(mesh):
            loss, _ = api.loss(state["params"], b0, cfg, mesh=mesh)
            loss = loss.full_tensor()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        out["loss0"] = float(loss)
        out["grads"] = {path: _full(g) for (path, _), g in zip(
            optim.named_leaves(state["params"]), grads)}
        step = train.place_train_step(
            train.make_train_step(api, cfg, tcfg, mesh), state_sh, batch_sh)
        out["metrics"] = []
        for b in batches:
            state, m = step(state, b)
            out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"] = {path: _full(p) for path, p in
                         optim.named_leaves(state["params"])}
        if opt.quantize_states:  # the 8-bit moments, gathered
            out["moments"] = {path: t.full_tensor().numpy() for path, t in
                              optim.named_leaves(state["opt"]["moments"])}
            out["split_blocks"] = sorted(
                str(path) for path, p in optim.named_leaves(state["params"])
                if not optim._last_dim_split(p)[1])
        return out

    def moe(case):
        from repro_torch.launch import sharding as shd
        from repro_torch.models import moe as moe_lib

        cfg = ModelConfig(**case["cfg"])
        mesh = make_local_mesh(2, 2, device="cpu")
        p = _tensors(case["moe"])
        specs = {"router": {"w": ("data", None)},
                 "up": ("model", None, None), "gate": ("model", None, None),
                 "down": ("model", None, None),
                 "shared": {k: {"w": ("data", "model") if k != "down"
                                else ("model", "data")}
                            for k in ("up", "gate", "down")}}
        placed = train._place_tree(p, _shardings(specs, mesh))
        x = shd.place(torch.from_numpy(case["x"]),
                      shd.NamedSharding(mesh, ("data", None, None)))
        with nn.mesh_context(mesh):
            y, aux = moe_lib.moe_apply(placed, x, cfg, mesh=mesh)
        return {"y": _full(y), "aux": float(_full(aux))}

    programs = {"step": run, "moe": moe}
    return _each(payload["cases"], lambda c: programs[c["kind"]](c))


def _tensors(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _shardings(specs, mesh):
    from repro_torch.launch import sharding as shd

    if isinstance(specs, dict):
        return {k: _shardings(v, mesh) for k, v in specs.items()}
    return shd.NamedSharding(mesh, specs)


# ---------------------------------------------------------------------------
# Serving under a mesh
# ---------------------------------------------------------------------------


def _greedy(logits):
    return [int(t) for t in np.asarray(logits).argmax(-1)]


def serve_steps(rank, payload):
    """Each case: the parameters placed by ``SERVE_RULES`` on a 2 x 2
    mesh, ``prefill`` of the prompts, its cache laid out by
    ``cache_specs`` (``nn.lay_out_cache``, as a pool lays out its own), an
    ``extend`` chunk (dense/moe), then greedy ``decode_step``s (and,
    for ``paged``, ``paged_decode_step``s on a store whose kv heads lie on
    "model"); every logits gathered."""
    import torch

    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import get_model, nn
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.convert import params_from_numpy

    mesh = make_local_mesh(2, 2, device="cpu")

    def run(case):
        cfg = ModelConfig(**case["cfg"])
        api = get_model(cfg)
        _, axes = api.init(torch.Generator(), cfg, device="meta",
                           with_axes=True)
        params = shd.place_params(
            params_from_numpy(case["weights"], cfg, "cpu"), axes, cfg, mesh)
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        out = {"decode": [], "tokens": []}
        with torch.no_grad():
            cache, logits = api.prefill(params, batch, cfg,
                                        max_len=case["max_len"], mesh=mesh)
            out["prefill"] = _full(logits)
            cache = nn.lay_out_cache(cache, mesh)
            if case.get("extend") is not None:
                cache, logits = api.extend(
                    params, cache, torch.from_numpy(case["extend"]), cfg,
                    mesh=mesh)
                out["extend"] = _full(logits)
                tok = _greedy(out["extend"][:, -1])
            else:
                tok = _greedy(out["prefill"])
            for _ in range(case["steps"]):
                out["tokens"].append(tok)
                cache, logits = api.decode(
                    params, cache, torch.tensor(tok, dtype=torch.int32), cfg,
                    mesh=mesh)
                out["decode"].append(_full(logits))
                tok = _greedy(out["decode"][-1])
            out["cache_placements"] = _placements(cache)
            if case.get("paged"):
                out["paged"], out["paged_local_heads"] = _paged(
                    api, cfg, params, case, mesh)
        return out

    def engine(case):
        import dataclasses as dc

        import torch.distributed as dist

        from repro_torch.serving.engine import InferenceEngine

        cfg = ModelConfig(**case["cfg"])
        _, axes = get_model(cfg).init(torch.Generator(), cfg, device="meta",
                                      with_axes=True)
        plain = params_from_numpy(case["weights"], cfg, "cpu")
        out = {}
        for name, m, params in (
                ("one", None, plain),
                ("mesh", mesh, shd.place_params(plain, axes, cfg, mesh))):
            eng = InferenceEngine(cfg, params, paged=case["paged"],
                                  block_size=case["block_size"],
                                  device="cpu", mesh=m, **case["engine_kw"])
            uids = [eng.submit(p, max_new_tokens=case["new_tokens"])
                    for p in case["prompts"]]
            with torch.no_grad():
                done = eng.run()
            stats = {k: v for k, v in dc.asdict(eng.stats).items()
                     if k != "started"}
            out[name] = {"outputs": [done[u].output for u in uids],
                         "stats": stats,
                         "telemetry": eng.block_telemetry()}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, out["mesh"])
        out["ranks_equal"] = all(e == out["mesh"] for e in every)
        return out

    programs = {"serve": run, "engine": engine}
    return _each(payload["cases"], lambda c: programs[c["kind"]](c))


def _placements(tree, path=()):
    """{"a/b": placements} of a tree's DTensor leaves."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _placements(sub, path + (key,)).items()}
    if hasattr(tree, "placements"):
        return {"/".join(path): _pl(tree.placements)}
    return {}


def _paged(api, cfg, params, case, mesh):
    """``paged_decode_step`` on a store laid out as the engine's (kv heads
    on "model"), from the case's store, tables and tokens -> (the logits
    of each step, gathered; the store's local kv heads)."""
    import torch

    from repro_torch.serving.kvcache import place_store

    pg = case["paged"]
    store = place_store({k: torch.from_numpy(v.copy())
                         for k, v in pg["store"].items()}, mesh)
    bt = torch.from_numpy(pg["tables"])
    lens = torch.from_numpy(pg["lens"])
    outs = []
    for tok, wp, wo in zip(pg["tokens"], pg["write_phys"], pg["write_off"]):
        store, logits = api.decode_paged(
            params, store, bt, lens, torch.from_numpy(tok),
            torch.from_numpy(wp), torch.from_numpy(wo), cfg, mesh=mesh)
        outs.append(_full(logits))
        lens = lens + 1
    return outs, int(store["k"].to_local().shape[3])
