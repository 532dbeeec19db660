"""Shared fixtures of the posfeat_tpu_torch parity tests: a small PoSFeat
configuration, JAX variables with every parameter and BatchNorm
statistic drawn from a seed, and the port model carrying them."""

import copy
import os

import numpy as np
import torch

# Under pytest-xdist every worker runs its tests beside the others. torch's
# default of one OpenMP thread per core then puts workers x cores threads on
# the cores, and their spin-waits stall each other: a port test ran 18x
# slower beside five copies of itself than alone. Each worker (and each
# process it spawns, through OMP_NUM_THREADS) takes its share of the cores.
# Every worker collects every test file, so this runs in each of them.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 1:
    _SHARE = max(1, (os.cpu_count() or 1) // _WORKERS)
    os.environ["OMP_NUM_THREADS"] = str(_SHARE)
    torch.set_num_threads(_SHARE)

SMALL_CONFIG = {
    "backbone": "ResUNet",
    "backbone_config": {
        "encoder": "resnet18",
        "pretrained": False,
        "coarse_out_ch": 32,
        "fine_out_ch": 32,
    },
    "localheader": "KeypointDet",
    "localheader_config": {
        "in_channels": 96,
        "out_channels": 2,  # a live local_thr in the output dict
        "prior": "identity",
        "act": "Softplus",
    },
    "align_local_grad": False,
    "local_input_elements": ["local_map", "local_map_small"],
    "local_with_img": True,
}


def randomize(tree, rng):
    """Numpy copy of a flax variable tree with biases, BatchNorm affine
    parameters and running statistics redrawn, so a weight mapping that
    swaps or drops one of them cannot pass."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k in ("bias",):
            v = rng.randn(*v.shape).astype(np.float32) * 0.1
        elif k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "mean":
            v = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
        out[k] = np.array(v)
    return out


def jax_posfeat(config=SMALL_CONFIG, seed=0, im_shape=(1, 64, 96, 3)):
    """(JAX PoSFeat f32, its randomized numpy variables)."""
    import jax
    import jax.numpy as jnp

    from posfeat_tpu.models import PoSFeat

    model = PoSFeat(copy.deepcopy(config), dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), im_shape=im_shape)
    return model, randomize(jax.tree.map(np.asarray, variables), np.random.RandomState(seed))


def pairs_close(kp_a, sc_a, de_a, kp_b, sc_b, de_b):
    """Two extractions of one image agree: keypoints paired one to one by
    nearest neighbour within 1e-3 px, scores within rtol 1e-3 and
    descriptors within atol 1e-4 (a swap of two near-equal scores in the
    top-k passes; a missing or moved keypoint fails)."""
    assert kp_a.shape == kp_b.shape and de_a.shape == de_b.shape
    d = np.linalg.norm(kp_a[:, None, :] - kp_b[None, :, :], axis=-1)
    j = d.argmin(axis=1)
    assert len(set(j.tolist())) == len(j), "keypoints pair up one to one"
    assert d[np.arange(len(j)), j].max() < 1e-3
    np.testing.assert_allclose(sc_a, sc_b[j], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(de_a, de_b[j], atol=1e-4)


def save_both_checkpoints(ck, config=SMALL_CONFIG, seed=7, im_shape=(1, 64, 96, 3)):
    """One set of random weights written into the directory ``ck`` in both
    checkpoint formats (the JAX msgpack files and the port's .pth files);
    returns (JAX model, numpy variables)."""
    import jax
    import jax.numpy as jnp
    import torch

    from posfeat_tpu_torch.core.jax_weights import from_jax_variables

    jmodel, variables = jax_posfeat(config, seed=seed, im_shape=im_shape)
    jmodel.save_checkpoint(jax.tree.map(jnp.asarray, variables), str(ck))
    for name, sd in from_jax_variables(variables).items():
        torch.save(sd, f"{ck}/{name}.pth")
    return jmodel, variables


def port_posfeat(variables, config=SMALL_CONFIG):
    """The port's PoSFeat on the CPU carrying the same weights."""
    from posfeat_tpu_torch.core.jax_weights import from_jax_variables
    from posfeat_tpu_torch.models import PoSFeat

    model = PoSFeat(copy.deepcopy(config), device="cpu")
    sds = from_jax_variables(variables)
    model.backbone.load_state_dict(sds["backbone"])
    model.localheader.load_state_dict(sds["localheader"])
    return model


def jax_disk_draws(kp1, kp2, key, grid_size):
    """JAX DiskLoss's draws for score maps kp1, kp2 (numpy [B, H, W, 1]),
    in its key-split order (disk_loss.py:86-90, 256-258): a list of
    (proposals, accept) numpy arrays, one pair per image."""
    import jax
    import jax.numpy as jnp

    from posfeat_tpu.ops.samplers import grid_bernoulli_accept, grid_categorical_sample

    out = []
    for kp, k in zip((kp1, kp2), jax.random.split(key)):
        k_cat, k_bern = jax.random.split(k)
        idx, _, cells = grid_categorical_sample(jnp.asarray(kp), grid_size, k_cat)
        accept, _ = grid_bernoulli_accept(cells, idx, k_bern)
        out.append((np.array(idx), np.array(accept)))
    return out


def torch_draws(draws):
    """jax_disk_draws' numpy pairs as the port's (int64, bool) tensors."""
    import torch

    return [(torch.from_numpy(p).long(), torch.from_numpy(a)) for p, a in draws]


def jax_line2window_draws(pp, inputs, outputs, key, chunk=64):
    """JAX Preprocess_Line2Window's draws for preprocess key ``key``
    (k_pp of the trainer's split into (k_pp, k_loss)), in its key order
    (preprocess.py:88-91, samplers.py:136-150, line_window.py:224,
    epipolar.py:176-180): ``key`` splits into (k_kps, k_ls1, k_ls2);
    k_kps into the two images; with the fused engine each k_ls into one
    key per ``chunk`` queries. ``pp`` is the JAX preprocess, whose own
    score maps the grid draws read. Returns the port's draws dict as
    numpy arrays."""
    import jax
    import jax.numpy as jnp

    from posfeat_tpu.ops.samplers import unfold

    cfg = pp.config
    gcfg = cfg["kps_generator_config"]
    g, select = gcfg["grid_size"], gcfg.get("random_select", "random")
    k_kps, k_ls1, k_ls2 = jax.random.split(key, 3)
    kps = []
    for kp, k in zip(pp._kp_maps(inputs, outputs), jax.random.split(k_kps)):
        if select == "random":
            kps.append(np.array(jax.random.categorical(k, unfold(kp, g)[:, :, :, 0, :], axis=-1)))
        else:
            kps.append(np.array(jax.random.uniform(k, (kp.shape[0], 1, 1, 2), kp.dtype)))
    draws = {"kps": kps, "jitter1": None, "jitter2": None}
    lcfg = cfg.get("line_search_config") or {}
    if cfg["use_line_search"] and lcfg.get("loc_rand", True):
        for name, k, im in (("jitter1", k_ls1, "im1"), ("jitter2", k_ls2, "im2")):
            B, H, W = inputs[im].shape[:3]
            n = (H // g) * (W // g)
            if cfg.get("engine", "fused") == "fused":
                keys = jax.random.split(k, -(-n // chunk))
                u = jnp.concatenate([jax.random.uniform(kk, (B, chunk, 2), jnp.float32) for kk in keys], 1)
                draws[name] = np.array(u[:, :n])
            else:
                draws[name] = np.array(jax.random.uniform(k, (B, n, 2), jnp.float32))
    return draws


def torch_line2window_draws(draws):
    """jax_line2window_draws' numpy arrays as the port's tensors."""
    import torch

    kps = tuple(torch.from_numpy(np.asarray(d)) for d in draws["kps"])
    kps = tuple(d.long() if d.dtype in (torch.int32, torch.int64) else d for d in kps)
    return {"kps": kps, **{k: None if draws[k] is None else torch.from_numpy(draws[k])
                           for k in ("jitter1", "jitter2")}}


def write_jax_init(ck, config, seed=0):
    """The JAX PoSFeat's initial weights for ``seed`` (JaxTrainer's
    ``model.init(PRNGKey(seed))``) as the port's ``backbone.pth`` and
    ``localheader.pth`` in the directory ``ck``; returns ``ck``."""
    import os

    import jax
    import torch

    from posfeat_tpu.models import PoSFeat
    from posfeat_tpu_torch.core.jax_weights import from_jax_variables

    os.makedirs(ck, exist_ok=True)
    variables = PoSFeat(copy.deepcopy(config)).init(jax.random.PRNGKey(seed))
    for name, sd in from_jax_variables(jax.tree.map(np.asarray, variables)).items():
        torch.save(sd, os.path.join(ck, f"{name}.pth"))
    return ck
