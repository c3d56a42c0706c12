"""Inverse rendering: gradient-descent fitting of scene parameters.

The capability the reference lacks and the north star demands: pixel
losses backpropagate to sphere centers/radii, material albedo/fuzz/
ir/absorption/emit, and camera parameters. This module runs the
optimization loop (optax) with periodic checkpointing so long fits
resume after preemption — the checkpoint/resume subsystem the reference
has no analog for (SURVEY.md §5: scene params + optimizer state are the
full training state).

Parameters are addressed by dotted paths into the Scene pytree
(e.g. "spheres.center", "materials.albedo"), so any differentiable
subset can be optimized while the rest stays frozen.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import jax
import jax.numpy as jnp
import optax

from tracer.render import camera as camera_mod
from tracer.render import renderer
from tracer.scene.types import Scene

DEFAULT_PARAMS = ("spheres.center", "spheres.radius", "materials.albedo")


def get_path(tree, path: str):
    for part in path.split("."):
        tree = getattr(tree, part)
    return tree


def set_path(tree, path: str, value):
    """Functional set on nested NamedTuples."""
    parts = path.split(".")
    if len(parts) == 1:
        return tree._replace(**{parts[0]: value})
    head = parts[0]
    sub = set_path(getattr(tree, head), ".".join(parts[1:]), value)
    return tree._replace(**{head: sub})


def extract_params(scene: Scene, paths: Iterable[str]) -> Dict[str, jnp.ndarray]:
    return {p: get_path(scene, p) for p in paths}


def apply_params(scene: Scene, params: Dict[str, jnp.ndarray]) -> Scene:
    for p, v in params.items():
        scene = set_path(scene, p, v)
    return scene


def render_loss_fn(
    scene: Scene,
    cam: camera_mod.CameraData,
    target,  # [H, W, 3] mean radiance
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    chunk: Optional[int] = None,
    cam_spec: Optional[Dict] = None,
) -> Callable:
    """L2 image loss as a function of a params dict.

    `cam_spec` (dict with "origin"/"look_at" and optionally "vfov",
    "vup", "background") enables CAMERA parameters in the params dict:
    keys prefixed "camera." override the spec and the camera is rebuilt
    differentiably inside the loss (gradients flow through the look-at
    basis and the viewport — camera.cu:171-196 math).
    """
    target = jnp.asarray(target, jnp.float32)
    chunk = chunk or min(renderer.DEFAULT_CHUNK, width * height)

    def loss(params, target=target, scene=scene, cam_spec=cam_spec):
        # target/scene/cam_spec are overridable so fit() can pass them as
        # jit arguments: the non-optimized leaves (textures especially:
        # tens of MB) would otherwise embed in the program as constants
        cam_l = cam
        if cam_spec is not None:
            spec = dict(cam_spec)
            for k, v in params.items():
                if k.startswith("camera."):
                    spec[k[len("camera."):]] = v
            cam_l = camera_mod.build_camera_data(
                width=width, height=height, **spec)
        s = apply_params(
            scene, {k: v for k, v in params.items()
                    if not k.startswith("camera.")})
        fb = renderer.render_frame(
            s, cam_l, width, height, spp=spp, max_depth=max_depth, chunk=chunk
        )
        return jnp.mean((fb / spp - target) ** 2)

    return loss


def save_checkpoint(path: str, step: int, params: Dict, opt_state) -> None:
    """Flat npz checkpoint: step + params + optimizer state leaves."""
    flat_opt, treedef = jax.tree_util.tree_flatten(opt_state)
    arrays = {f"param:{k}": np.asarray(v) for k, v in params.items()}
    arrays.update({f"opt:{i}": np.asarray(v) for i, v in enumerate(flat_opt)})
    arrays["step"] = np.asarray(step)
    tmp = path + ".tmp.npz"  # np.savez appends .npz unless present
    np.savez(tmp, **arrays)
    os.replace(tmp, path)  # atomic publish


def load_checkpoint(path: str, params_template: Dict, opt_state_template):
    """Inverse of save_checkpoint; returns (step, params, opt_state)."""
    with np.load(path) as z:
        step = int(z["step"])
        params = {k: jnp.asarray(z[f"param:{k}"]) for k in params_template}
        flat_t, treedef = jax.tree_util.tree_flatten(opt_state_template)
        flat = [jnp.asarray(z[f"opt:{i}"]) for i in range(len(flat_t))]
        opt_state = jax.tree_util.tree_unflatten(treedef, flat)
    return step, params, opt_state


def fit(
    scene: Scene,
    cam: camera_mod.CameraData,
    target,
    width: int,
    height: int,
    spp: int = 4,
    max_depth: int = 6,
    param_paths: Iterable[str] = DEFAULT_PARAMS,
    steps: int = 100,
    learning_rate: float = 1e-2,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 25,
    log_every: int = 10,
    log=print,
    cam_spec: Optional[Dict] = None,
):
    """Fit the named scene parameters to a target image.

    Returns (fitted_scene, losses), or (fitted_scene, losses,
    fitted_cam_spec) when `cam_spec` is given. `cam_spec` (dict with
    "origin", "look_at", optionally "vfov"/"vup"/"background") enables
    camera fitting: include "camera.origin" / "camera.look_at" /
    "camera.vfov" in param_paths. If `checkpoint_path` exists, training
    resumes from it (step counter, params, optimizer moments).
    """
    param_paths = tuple(param_paths)
    cam_keys = [p for p in param_paths if p.startswith("camera.")]
    if cam_keys and cam_spec is None:
        raise ValueError("camera.* param_paths require cam_spec")
    if cam_spec is not None:
        cam_spec = {k: (v if k in ("vfov",) else jnp.asarray(v, jnp.float32))
                    for k, v in cam_spec.items()}
        cam_spec.setdefault("vfov", camera_mod.DEFAULT_VFOV)
    loss_fn = render_loss_fn(scene, cam, target, width, height, spp, max_depth,
                             cam_spec=cam_spec)
    target_arg = jnp.asarray(target, jnp.float32)

    opt = optax.adam(learning_rate)
    params = extract_params(scene, [p for p in param_paths
                                    if not p.startswith("camera.")])
    for p in cam_keys:
        key = p[len("camera."):]
        params[p] = jnp.asarray(cam_spec[key], jnp.float32)
    opt_state = opt.init(params)
    start_step = 0

    if checkpoint_path and os.path.exists(checkpoint_path):
        start_step, params, opt_state = load_checkpoint(checkpoint_path, params, opt_state)
        log(f"resumed from {checkpoint_path} at step {start_step}")

    @jax.jit
    def update(params, opt_state, target, scene, cam_spec):
        # target AND the scene/camera spec are jit ARGUMENTS, never
        # closure constants (see render_loss_fn). loss overrides cam_spec
        # entries with the corresponding "camera." params, so gradients
        # flow to them.
        loss, grads = jax.value_and_grad(loss_fn)(params, target, scene, cam_spec)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for step in range(start_step, steps):
        params, opt_state, loss = update(params, opt_state, target_arg, scene,
                                         cam_spec)
        losses.append(float(loss))
        if log_every and step % log_every == 0:
            log(f"step {step}\tloss {float(loss):.6g}")
        if checkpoint_path and checkpoint_every and (step + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, step + 1, params, opt_state)

    if checkpoint_path:
        save_checkpoint(checkpoint_path, steps, params, opt_state)
    fitted_scene = apply_params(
        scene, {k: v for k, v in params.items() if not k.startswith("camera.")})
    if cam_spec is not None:
        fitted_spec = dict(cam_spec)
        fitted_spec.update({p[len("camera."):]: params[p]
                            for p in params if p.startswith("camera.")})
        return fitted_scene, losses, fitted_spec
    return fitted_scene, losses
