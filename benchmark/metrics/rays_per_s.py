"""rays_per_s: ray segments (W*H*spp*dof*level a frame) of every frame
finished in the window, over the window's host-clock seconds."""


def read(run):
    return run.work / run.window_s if run.window_s > 0 and run.units else None
