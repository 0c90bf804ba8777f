"""The one general generator of the benchmark's traffic.

A configuration (benchmark/configs/<config>.json) names its mesh kind
(meshes/<kind>.py), its physics (physics/<physics>.py), the Dirichlet set
and how loads are drawn; a mix (benchmark/mixes/<mix>.json) is data: the
entry it drives (entries/<entry>.py), the precision, tolerance and options,
and what one unit of work is.  From them and a seed this module makes every
input, calls the entry, and keeps what the check needs.  It knows no entry,
mesh or physics by name.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from benchmark.harness import registry


class Traffic:
    """One cell's inputs and its calls into the port."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix = config, mix
        self.entry = registry.module("entries", mix["entry"])
        self.physics = registry.module("physics", config["physics"])
        self.mesh_kind = registry.module("meshes", config["mesh"]["kind"])
        self.device = torch.device(device)
        self.dtype = getattr(torch, mix["dtype"])
        self.mesh_arrays = self.mesh_kind.build(config["mesh"])
        self.bc_nodes = self.mesh_kind.boundary_nodes(
            self.mesh_arrays, config["dirichlet"]["faces"])
        self.seed = int(seed) % (1 << 64)
        self.reset()

    def warm(self) -> "Traffic":
        """The same cell on its mesh kind's small mesh: the warm-up, which
        builds every kernel the window runs without the full size's host
        work."""
        cfg = dict(self.config, mesh=self.mesh_kind.small(self.config["mesh"]))
        return Traffic(cfg, self.mix, self.seed, self.device)

    def reset(self):
        """Start the seed's sequence of loads (and a resumed run) anew."""
        self.rng = np.random.default_rng(self.seed)
        self.state = None          # what the next unit resumes from
        self.step = 0
        self.run_load = None       # a resumed run's load, drawn once

    # ---- inputs -----------------------------------------------------------
    def next_load(self) -> dict:
        """The next load, each drawn value uniform in its [lo, hi]."""
        spec = self.config["load"]
        return {k: float(self.rng.uniform(*spec["draw"][k]))
                for k in sorted(spec["draw"])}

    def dirichlet(self, load: dict) -> np.ndarray:
        """The port's (rows, 3) [node, dof, value] Dirichlet rows."""
        return self.physics.dirichlet_rows(self, load)

    def port_mesh(self):
        """A Mesh built anew from the arrays, as reading the files would, with
        the generator's structure tag."""
        from pfemfort_tpu_torch import Mesh
        m = self.mesh_arrays
        return Mesh(m.etype, m.coords, m.conn, structure=m.structure)

    # ---- one unit of work ---------------------------------------------------
    def run_unit(self, steps: Optional[int] = None) -> dict:
        """One unit of the mix, as its entry makes it: the answer (host
        arrays), the load and what the program reported; `steps` overrides
        a block's length (the warm-up)."""
        load = self.next_load()
        t0 = time.perf_counter()
        unit = self.entry.run(self, load, steps)
        unit["seconds"] = time.perf_counter() - t0
        unit["load"] = load
        return unit
