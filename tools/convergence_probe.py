"""Per-iteration convergence trajectories of the level loop.

Runs the coarse-to-fine pipeline on an octave-texture pair and prints,
for every level, the per-iteration confidence-weighted mean |disparity
change| (max over the two axes) — the reference's weightedDifference
metric (MatchGPULib.cpp:1336-1437) traced through the live loop body via
``match.level_convergence_trace``.  Use it to pick
``MatcherConfig.early_exit_delta`` for a deployment: the printed
trajectories show how many iterations each level would run at a given
threshold and what residual change the cut-off leaves on the table.

On a 408x616 octave texture the deltas decay slowly — mid levels still
move 0.03-0.07 px/iteration at the end of their schedule — so the
reference's fixed schedule is tight for natural textures and small
thresholds trim only a little.  Early exit pays on easy scenes (low
texture, small true disparity), not as a blanket speedup.

Usage:  python tools/convergence_probe.py [H W] [--cpu]
        (defaults 408 616; --cpu forces the CPU backend)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    sys.argv.remove("--cpu")
    os.environ["BENCH_PLATFORM"] = "cpu"
from bench import _make_pair, _setup_jax  # noqa: E402

jax = _setup_jax()
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ug_stereomatcher import MatcherConfig  # noqa: E402
from ug_stereomatcher import match as match_mod  # noqa: E402
from ug_stereomatcher import pyramid as pyr  # noqa: E402


def main():
    h = int(sys.argv[1]) if len(sys.argv) > 2 else 408
    w = int(sys.argv[2]) if len(sys.argv) > 2 else 616
    left, right = _make_pair(h, w)
    cfg = MatcherConfig()
    l = jnp.asarray(np.moveaxis(left, -1, 0).astype(np.float32))
    r = jnp.asarray(np.moveaxis(right, -1, 0).astype(np.float32))
    n = cfg.num_levels(h, w)
    lp, rp = pyr.build_pyramid_pair(l, r, cfg, n)
    dims = match_mod.level_dims_for_matching(cfg, h, w, n, False)
    hh, ww = dims[n - 1]
    disp = jnp.zeros((3, hh, ww), jnp.float32)
    print(f"# convergence probe {h}x{w}, {n} levels, "
          f"device={jax.devices()[0].device_kind}")
    for i in range(n - 1, -1, -1):
        out, deltas = match_mod.level_convergence_trace(
            lp[i], rp[i], disp, i, cfg, i == n - 1)
        d = np.asarray(deltas).max(axis=1)
        print(f"L{i:<2} ({dims[i][0]}x{dims[i][1]}) mi={len(d)}: "
              + " ".join(f"{v:.4f}" for v in d))
        disp = out
        if i:
            disp = pyr.upsample_to_level(out, dims[i - 1][0],
                                         dims[i - 1][1], cfg)


if __name__ == "__main__":
    main()
