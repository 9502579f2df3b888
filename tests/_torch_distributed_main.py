"""The JAX side of the p = 8 checks of tests/test_torch_sharding.py,
tests/test_torch_moe_ep.py and tests/test_torch_pipeline.py.

Runs one group of tests/_torch_distributed_cases.py (``sharding``,
``moe_ep`` or ``pipeline``) on 8 fake XLA host devices and writes its
arrays to the ``.npz`` named on the command line. The tests start it in a
subprocess, so the 8-device flag never reaches the pytest process:

    python tests/_torch_distributed_main.py moe_ep /tmp/moe_ep.npz
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import json  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_distributed_cases as cases  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.core import compat  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402


def sharding_group() -> dict:
    out = {}
    meshes = []
    for factory, args in cases.MESH_FACTORIES:
        m = getattr(jmesh, factory)(*args)
        meshes.append({"names": list(m.axis_names), "shape": {k: int(v) for k, v in
                                                               m.shape.items()}})
    out["meshes"] = np.asarray(json.dumps(meshes))
    for i, (shape, names, spec, leaf) in enumerate(cases.PLACEMENTS):
        m = compat.make_mesh(shape, names)
        index = NamedSharding(m, P(*spec)).devices_indices_map(leaf)
        rows = []
        for d in m.devices.flat:  # rank order: the mesh's row-major devices
            rows.append([[s.start or 0, n if s.stop is None else s.stop]
                         for s, n in zip(index[d], leaf)])
        out[f"placement|{i}"] = np.asarray(rows, np.int64)
    return out


def moe_config(cf):
    from repro.configs import get_config

    E, K, D, F = cases.EP_DIMS
    return get_config("phi3.5-moe-42b-a6.6b").reduced().with_overrides(
        num_experts=E, experts_per_token=K, d_model=D, d_ff=F, moe_ep=True,
        capacity_factor=cf)


def moe_ep_group() -> dict:
    from repro.models.moe import make_moe_params, moe_apply, moe_ffn_bsd
    from repro.models.moe_ep import ep_applicable, moe_ffn_bsd_ep

    out = {}
    mesh = jmesh.make_local_mesh(cases.P8, 1)
    for name, (cf, x_shape, seed) in cases.EP_CASES.items():
        cfg = moe_config(cf)
        if seed is None:  # the JAX package's own draws
            pm = make_moe_params(jax.random.PRNGKey(3), cfg, jnp.float32)
            x = jax.random.normal(jax.random.PRNGKey(4), x_shape)
            gy = np.asarray(jax.random.normal(jax.random.PRNGKey(5), x_shape))
        else:
            x, pm, gy = cases.ep_inputs(seed, x_shape)
        pm = {k: jnp.asarray(v) for k, v in pm.items()}
        x = jnp.asarray(x)

        def loss(x, p, cfg=cfg, gy=jnp.asarray(gy)):
            y, aux = moe_ffn_bsd_ep(x, p, cfg)
            return jnp.sum(y * gy) + cases.AUX_WEIGHT * aux

        with compat.set_mesh(mesh):
            assert ep_applicable(cfg)
            xs = jax.device_put(x, NamedSharding(mesh, P("data")))
            ps = jax.device_put(pm, NamedSharding(mesh, P()))
            y, aux = jax.jit(lambda x, p, cfg=cfg: moe_ffn_bsd_ep(x, p, cfg))(xs, ps)
            gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(xs, ps)
        y_flat, aux_flat = moe_ffn_bsd(x, pm, cfg)
        out.update({f"{name}|x": np.asarray(x), f"{name}|gy": np.asarray(gy),
                    f"{name}|y": np.asarray(y), f"{name}|aux": np.asarray(aux),
                    f"{name}|y_flat": np.asarray(y_flat),
                    f"{name}|aux_flat": np.asarray(aux_flat),
                    f"{name}|grad|x": np.asarray(gx)})
        for k, v in pm.items():
            out[f"{name}|param|{k}"] = np.asarray(v)
            out[f"{name}|grad|{k}"] = np.asarray(gp[k])

    rule = []
    for ep, shape, E in cases.EP_RULE:
        cfg = moe_config(1.25).with_overrides(moe_ep=ep, num_experts=E)
        if shape is None:
            rule.append(bool(ep_applicable(cfg)))
        else:
            with compat.set_mesh(jmesh.make_local_mesh(*shape)):
                rule.append(bool(ep_applicable(cfg)))
    out["rule"] = np.asarray(rule)

    # shapes EP cannot split: the JAX moe_apply falls back to the flat path
    cfg = moe_config(1.25)
    x0, pm, _gy = cases.ep_inputs(13, (16, 4, 32))
    pm = {k: jnp.asarray(v) for k, v in pm.items()}
    for i, shape in enumerate(cases.EP_FLAT_SHAPES):
        x = jnp.asarray(x0.reshape(-1, 32)[: int(np.prod(shape[:2]))].reshape(shape))
        with compat.set_mesh(mesh):
            assert ep_applicable(cfg)
            y, aux = moe_apply(x, pm, cfg)
        y_flat, aux_flat = moe_ffn_bsd(x, pm, cfg)
        out[f"flat{i}|x"] = np.asarray(x)
        out[f"flat{i}|y"] = np.asarray(y)
        out[f"flat{i}|aux"] = np.asarray(aux)
        out[f"flat{i}|same_as_flat"] = np.asarray(
            bool(jnp.array_equal(y, y_flat)) and bool(jnp.array_equal(aux, aux_flat)))
    for k, v in pm.items():
        out[f"flat|param|{k}"] = np.asarray(v)
    return out


def pipeline_group() -> dict:
    from repro.distributed.pipeline import pipeline_apply, reference_apply

    out = {}
    fn = cases.stage_fn(jnp)
    for name, (S, M, mb, d, _as_dict) in cases.PIPE_CASES.items():
        if name == "jax":  # the JAX package's own draws
            key = jax.random.PRNGKey(0)
            ws = jax.random.normal(key, (S, d, d)) * 0.3
            xm = jax.random.normal(key, (M, mb, d))
        else:
            ws, xm = cases.pipe_inputs(name)
            ws = jax.tree.map(jnp.asarray, ws)
            xm = jnp.asarray(xm)
        pmesh = jmesh.make_pp_mesh(S, 1)
        with compat.set_mesh(pmesh):
            got = pipeline_apply(ws, xm, fn, pmesh)
        ref = reference_apply(ws, xm, fn)
        out[f"{name}|x"] = np.asarray(xm)
        if isinstance(ws, dict):
            for k, v in ws.items():
                out[f"{name}|param|{k}"] = np.asarray(v)
        else:
            out[f"{name}|param"] = np.asarray(ws)
        out[f"{name}|got"] = np.asarray(got)
        out[f"{name}|ref"] = np.asarray(ref)
    return out


GROUPS = {"sharding": sharding_group, "moe_ep": moe_ep_group, "pipeline": pipeline_group}


def main(group: str, out_path: str):
    assert len(jax.devices()) == cases.P8, jax.devices()
    out = GROUPS[group]()
    np.savez(out_path, **out)
    print("TORCH_DISTRIBUTED_JAX_OK", group, len(out))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
