"""Wavefront path-tracing integrator (port of
`gpu_pathtracer_tpu.render.integrator`).

All rays advance one bounce per step: closest hit -> winner barycentrics ->
hit interpolation -> BSDF sample -> NEE/MIS with the light tree ->
emission / sky -> dielectric-stack update.  Randomness is eight uniforms per
ray and bounce, drawn from an explicit `torch.Generator` or passed in as a
(level, 8, R) tensor so that a test can feed the reference's numbers; a scene
whose light tree is in the sparse regime (more than LIGHT_TREE_DENSE_MAX
emitters) also uses one uniform per step of the light-pick descent
(`pick_uniforms`, (level, descent steps, R)).  A diffuse hit on a material
with a scattering path length ends the path with the gather over the scene's
SSS point cloud (`render.sss`), when the scene carries one.

Shading stays in differentiable torch ops (only the closest-hit query is
not differentiable); callers that only render wrap the call in
`torch.no_grad()`.

A step makes one call a stage: `trace.closest_hit`, `surface.shade`,
`lights.nee`, the accumulate step; the first three take the port's kernels
where no gradient is asked for (`ops.route`) and no scene tensor requires it.

A `render_image` call is a frame of the port's tracer (`tracing`): spans
`integrator.sample` for each chunk-sample and `integrator.step` for each
bounce, tiled by `dispatch.closest_hit`, `shading.surface`, `shading.nee`
and `shading.accumulate`.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.constants import MATERIAL_STACK_SIZE
from gpu_pathtracer_tpu_torch.models.scene import Scene
from gpu_pathtracer_tpu_torch.ops import lights as lights_mod
from gpu_pathtracer_tpu_torch.ops import linalg, materials, route, surface, texture, trace

# rows of the per-bounce uniforms
U_BSDF = slice(0, 4)  # u_choice, u_pick, u_lobe1, u_lobe2
U_ACCEPT, U_PICK, U_LIGHT1, U_LIGHT2 = 4, 5, 6, 7
N_UNIFORMS = 8


def _sky_color(scene: Scene, direction):
    return texture.lookup_sky(scene.sky_rgb, scene.sky_h, scene.sky_w, direction,
                              scene.sky_emission)


def trace_paths(
    scene: Scene,
    origin: torch.Tensor,  # (R, 3)
    direction: torch.Tensor,  # (R, 3) unit
    level: int = 8,
    hittable_pdf_weight: float = 0.0,
    stack_size: int = MATERIAL_STACK_SIZE,
    generator: torch.Generator | None = None,
    uniforms: torch.Tensor | None = None,
    pick_uniforms: torch.Tensor | None = None,
    sss_first_pass: bool = False,
    return_stats: bool = False,
):
    """Radiance (R, 3) for a batch of rays, one wavefront step per bounce.

    Per bounce each ray uses eight uniforms: rows 0-3 go to `sample_bsdf`,
    rows 4-7 to `lights.nee_mis` (u_accept, light pick, u1, u2).  They come
    from `uniforms` (level, 8, R) when given, else from `generator`.  In the
    sparse light-tree regime the pick is a descent with one uniform per step:
    `pick_uniforms` (level, `lights.descent_steps`, R), else drawn from
    `generator` after the eight.

    `sss_first_pass` traces the irradiance paths of the SSS point cloud: SSS
    hits then take NEE like any other and no gather is made.  With
    `return_stats` returns (radiance, stats), stats["mis_targets_dropped"]
    the total of emitter leaves dropped past MAX_POTENTIAL_TARGETS over all
    (ray, bounce) mixture-pdf sums (a 0-d int64 tensor)."""
    r = origin.shape[0]
    dev = origin.device
    g = scene.geom
    if uniforms is not None and tuple(uniforms.shape) != (level, N_UNIFORMS, r):
        raise ValueError(f"uniforms must be ({level}, {N_UNIFORMS}, {r}), got {tuple(uniforms.shape)}")
    stack_ids, stack_len = materials.stack_init((r,), stack_size, device=dev)
    o, d = origin, direction
    mask = torch.ones((r, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    live = torch.ones((r,), dtype=torch.bool, device=dev)
    lt = scene.light_tree
    descent = lights_mod.descent_steps(lt) if lt is not None and not lt.dense else 0
    gather_sss = scene.sss is not None and not sss_first_pass
    sss_color = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    sss_done = torch.zeros((r,), dtype=torch.bool, device=dev)
    cap_mis = torch.zeros((), dtype=torch.int64, device=dev)
    # a scene tensor that requires grad keeps both passes of the path replay on torch ops
    kernels = not route.requires_grad(scene)

    for i in range(level):
        with tracing.span("integrator.step", bounce=i):
            if uniforms is not None:
                u = uniforms[i].to(dev)
            else:
                u = torch.rand((N_UNIFORMS, r), generator=generator, device=dev)
            u_descent = None
            if descent:
                if pick_uniforms is not None:
                    u_descent = pick_uniforms[i].to(dev)
                else:
                    u_descent = torch.rand((descent, r), generator=generator, device=dev)
            _, slot, bary, hit = trace.closest_hit(g, o, d, live=live, kernels=kernels)

            with tracing.span("shading.surface"):
                hit = hit & live
                point, uv, normal, mat_id, ref = surface.shade(
                    g, scene.materials, slot, bary, d, stack_ids, stack_len, u[U_BSDF], kernels)

            with tracing.span("shading.nee"):
                if lt is not None:
                    do_nee = hit & ~ref.false_hit
                    if not sss_first_pass:
                        do_nee = do_nee & ~ref.sss
                    next_dir, filt, factor, mis_dropped = lights_mod.nee(
                        lt, ref, normal, d, hittable_pdf_weight, u[U_ACCEPT:], u_descent, do_nee,
                        kernels)
                    if mis_dropped is not None:
                        cap_mis = cap_mis + mis_dropped
                else:
                    next_dir, filt = ref.dir, ref.filter
                    factor = torch.ones((r,), dtype=torch.float32, device=dev)

            with tracing.span("shading.accumulate"):
                # emission accumulation + throughput update
                emit = scene.materials.emission_color(mat_id, uv)
                real_hit = hit & ~ref.false_hit
                acc = acc + torch.where(real_hit[..., None], linalg.de_nan(mask * emit), 0.0)
                cont = factor > 0
                new_mask = torch.where(
                    (real_hit & cont)[..., None],
                    mask * filt * torch.clamp(factor, 0.0, 0.9999)[..., None],
                    mask,
                )

                # miss -> sky
                sky = _sky_color(scene, d)
                acc = acc + torch.where((live & ~hit)[..., None], linalg.de_nan(mask * sky), 0.0)
                mask = new_mask
                live = live & hit & (ref.false_hit | cont)

                # SSS diffuse hit: the path's radiance is the point-cloud gather,
                # whatever it accumulated before
                if gather_sss:
                    from gpu_pathtracer_tpu_torch.render import sss as sss_mod

                    sss_now = hit & ref.sss & ~sss_done
                    gathered = sss_mod.gather_sss_auto(
                        scene.sss, point, g.obj_id[torch.clamp(slot, min=0).long()],
                        scene.materials.path_length[torch.clamp(mat_id, min=0).long()],
                        scene.materials.diffuse_color(mat_id, uv), sss_now,
                    )
                    sss_color = torch.where(sss_now[..., None], gathered, sss_color)
                    sss_done = sss_done | sss_now
                    live = live & ~sss_now

                stack_ids, stack_len = materials.stack_rearrange(
                    stack_ids, stack_len, mat_id, ref.false_hit, ref.entering, ref.refracted, hit
                )
                o = torch.where(hit[..., None], ref.origin, o)
                d = torch.where(hit[..., None], next_dir, d)

    out = linalg.de_nan(torch.where(sss_done[..., None], sss_color, acc))
    if return_stats:
        return out, {"mis_targets_dropped": cap_mis}
    return out


def _pixel_chunks(width: int, height: int, ray_chunk: int, dev):
    """Pixel centres of the frame as (n_chunks, chunk) rows and columns,
    padded with pixel (0, 0) to whole chunks; also the pixel count."""
    ii, jj = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    pix_i = ii.reshape(-1) + 0.5
    pix_j = jj.reshape(-1) + 0.5
    n_pix = pix_i.shape[0]
    chunk = min(ray_chunk, n_pix)
    pad = (-n_pix) % chunk
    if pad:
        zeros = torch.zeros((pad,), dtype=torch.float32, device=dev)
        pix_i = torch.cat([pix_i, zeros])
        pix_j = torch.cat([pix_j, zeros])
    return pix_i.reshape(-1, chunk), pix_j.reshape(-1, chunk), n_pix


def path_uniforms(scene: Scene, level: int, r: int, generator, device):
    """The numbers that `trace_paths` draws from `generator` for `r` rays, in
    its order (per bounce the (8, r) uniforms, then in the sparse light-tree
    regime the (descent steps, r) pick uniforms): (uniforms (level, 8, r),
    pick_uniforms (level, descent steps, r) or None)."""
    lt = scene.light_tree
    descent = lights_mod.descent_steps(lt) if lt is not None and not lt.dense else 0
    us, picks = [], []
    for _ in range(level):
        us.append(torch.rand((N_UNIFORMS, r), generator=generator, device=device))
        if descent:
            picks.append(torch.rand((descent, r), generator=generator, device=device))
    return torch.stack(us), (torch.stack(picks) if descent else None)


def _chunk_sample(scene, camera, pix_i, pix_j, level, hittable_pdf_weight, stack_size,
                  generator, cols: slice | None = None) -> torch.Tensor:
    """One sample of one chunk of pixels: a fresh lens/pixel jitter, then the
    paths.  (chunk, 3) radiance.  `cols` traces only those columns of the
    chunk, from the numbers that the whole chunk draws (a rank's share of a
    sharded render): (columns, 3)."""
    with tracing.span("integrator.sample"):
        n = pix_i.shape[0]
        u = torch.rand((2, n), generator=generator, device=pix_i.device)
        if cols is None:
            o, d = camera.generate_rays(pix_i, pix_j, u[0], u[1])
            col = trace_paths(
                scene, o, d, level=level, hittable_pdf_weight=hittable_pdf_weight,
                stack_size=stack_size, generator=generator,
            )
            return linalg.de_nan(col)
        uniforms, picks = path_uniforms(scene, level, n, generator, pix_i.device)
        o, d = camera.generate_rays(pix_i[cols], pix_j[cols], u[0, cols], u[1, cols])
        col = trace_paths(
            scene, o, d, level=level, hittable_pdf_weight=hittable_pdf_weight,
            stack_size=stack_size, uniforms=uniforms[..., cols],
            pick_uniforms=None if picks is None else picks[..., cols],
        )
        return linalg.de_nan(col)


def _assemble(mesh, totals, chunk: int):
    """The (n_chunks, chunk, 3) totals of every chunk from each rank's
    (n_chunks, columns, 3) share."""
    sizes = [hi - lo for lo, hi in mesh.bounds(chunk)]
    return mesh.all_gather(totals.transpose(0, 1).contiguous(), sizes).transpose(0, 1)


def render_image(
    scene: Scene,
    camera,
    width: int,
    height: int,
    sample_size: int = 16,
    dof_sample_size: int = 1,
    level: int = 8,
    hittable_pdf_weight: float = 0.0,
    stack_size: int = MATERIAL_STACK_SIZE,
    ray_chunk: int = 65536,
    generator: torch.Generator | None = None,
    mesh=None,
) -> torch.Tensor:
    """Full-frame render: `ray_chunk`-ray wavefronts, samples in sequence,
    every one of the sample_size * dof_sample_size samples with a fresh lens
    sample.  Traces width * height * sample_size * dof_sample_size * level
    ray segments.  Returns (H, W, 3) linear radiance.

    `mesh` (a `parallel.shard.Mesh`) splits every chunk's columns over its
    ranks: each rank draws what the whole chunk draws and traces its own
    columns, and the image is assembled with one all-gather, the same bits
    as without a mesh (`parallel.shard.render_image_distributed`; not
    differentiable through the gather).

    Differentiable as it stands (one autograd graph over every chunk and
    sample); `render_image_value_and_grad` is the form whose memory does not
    grow with the frame."""
    dev = scene.geom.p.device
    with tracing.frame("render.frame", dev):
        pix_i, pix_j, n_pix = _pixel_chunks(width, height, ray_chunk, dev)
        n_chunks, chunk = pix_i.shape
        cols = None if mesh is None else mesh.columns(chunk)
        n_samples = sample_size * dof_sample_size
        totals = [0.0] * n_chunks
        for _ in range(n_samples):
            for c in range(n_chunks):
                totals[c] = totals[c] + _chunk_sample(
                    scene, camera, pix_i[c], pix_j[c], level, hittable_pdf_weight, stack_size,
                    generator, cols)
        if mesh is None:
            img = torch.cat(totals)
        else:
            img = _assemble(mesh, torch.stack(totals), chunk).reshape(-1, 3)
        img = img[:n_pix] / n_samples
        return img.reshape(height, width, 3)


def render_image_value_and_grad(
    scene: Scene,
    camera,
    width: int,
    height: int,
    image_loss,
    wrt,
    sample_size: int = 16,
    dof_sample_size: int = 1,
    level: int = 8,
    hittable_pdf_weight: float = 0.0,
    stack_size: int = MATERIAL_STACK_SIZE,
    ray_chunk: int = 65536,
    generator: torch.Generator | None = None,
    mesh=None,
):
    """Loss of the rendered image and its gradient to the tensors `wrt`
    (tensors of `scene` that require grad), with the memory of one chunk's
    autograd graph whatever the frame and sample count.

    `image_loss` maps the (H, W, 3) image to a scalar.  The loss needs the
    finished image before any chunk's upstream gradient is known, so the
    render runs twice from the same generator states: first without a graph,
    recording the generator's state before every chunk-sample, which yields
    the image, the loss and dloss/dimage; then each chunk-sample again with a
    graph, backpropagated at once with its pixels' share of dloss/dimage.
    The paths of both passes are the same (path replay), and the generator
    ends where one render would leave it.  Returns (loss, image, grads), the
    loss and image detached, grads a tuple like `wrt` (zeros where the image
    does not depend on a tensor).

    With `mesh` (as `render_image`'s) each rank renders and replays its own
    columns; the image is all-gathered, so every rank computes the same loss
    and dloss/dimage from it, and the gradients are summed over the ranks
    once: every rank returns the same loss, image and gradients."""
    if generator is None:
        raise ValueError("render_image_value_and_grad replays the paths and needs a generator")
    wrt = tuple(wrt)
    dev = scene.geom.p.device
    pix_i, pix_j, n_pix = _pixel_chunks(width, height, ray_chunk, dev)
    n_chunks, chunk = pix_i.shape
    cols = None if mesh is None else mesh.columns(chunk)
    n_samples = sample_size * dof_sample_size
    args = (level, hittable_pdf_weight, stack_size, generator, cols)

    states = []
    width_mine = chunk if cols is None else cols.stop - cols.start
    total = torch.zeros((n_chunks, width_mine, 3), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for _ in range(n_samples):
            for c in range(n_chunks):
                states.append(generator.get_state())
                total[c] += _chunk_sample(scene, camera, pix_i[c], pix_j[c], *args)
    end_state = generator.get_state()
    if mesh is not None:
        total = _assemble(mesh, total, chunk)
    img = (total.reshape(-1, 3)[:n_pix] / n_samples).reshape(height, width, 3)
    img.requires_grad_(True)
    with torch.enable_grad():
        loss = image_loss(img)
    (d_img,) = torch.autograd.grad(loss, img)
    d_total = torch.zeros((n_chunks * chunk, 3), dtype=torch.float32, device=dev)
    d_total[:n_pix] = d_img.reshape(-1, 3) / n_samples
    d_total = d_total.reshape(n_chunks, chunk, 3)
    if cols is not None:
        d_total = d_total[:, cols]

    grads = [torch.zeros_like(p) for p in wrt]
    replay = iter(states)
    for _ in range(n_samples):
        for c in range(n_chunks):
            generator.set_state(next(replay))
            with torch.enable_grad():
                col = _chunk_sample(scene, camera, pix_i[c], pix_j[c], *args)
            if not col.requires_grad:
                continue
            part = torch.autograd.grad(col, wrt, grad_outputs=d_total[c], allow_unused=True)
            for acc, g in zip(grads, part):
                if g is not None:
                    acc += g
    generator.set_state(end_state)
    if mesh is not None:
        grads = [mesh.all_reduce(g) for g in grads]
    return loss.detach(), img.detach(), tuple(grads)
