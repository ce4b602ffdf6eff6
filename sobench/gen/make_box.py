"""Clustered periodic boxes made on the device from a seed.

The distribution is so_tpu's ``bench.make_box`` (bench.py:35-59): half the
particles in r^-2 clumps, one per candidate center, the other half a
uniform background over the unit box, catalog radii
``rgtp = max(0.0012 * n^(1/3), 0.001)``. The clump sizes are the set that
``bench.make_box`` draws, Lomax(1.5) + 1 scaled to half the particles with
a floor of 24, drawn once from the configuration's ``size_seed`` (numpy's
generator, as bench.py), so every seed gives the same particle count and
the same halo sizes; ``--seed`` draws everything else on the device:
centers, radii within each clump, directions, the background, the
velocities, the masses and species of the traffic mix, and the catalog
masses.

Velocities (the configuration's ``velocities``): a clump's particles move
with its bulk velocity, N(0, bulk^2) a component, plus N(0, internal^2)
each; the background N(0, background^2). bench.make_box leaves them zero;
here they are drawn so that the group mean velocity is a real sum.

The traffic mix (sobench/traffic/<mix>.json) sets the masses ("uniform":
1/N each; "range": U(lo, hi)/N), the species split (gas and star
fractions of the file, spatially mixed by one permutation; dark the rest)
and the catalog masses: "clump" gives each center its clump's particle
count times the mean particle mass, times U(1 - jitter, 1 + jitter), as a
group finder's catalog ties a group's mass to its size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Snapshot:
    """One generated snapshot and its candidate catalog, as host arrays
    (``run_so`` takes host arrays, as after a tipsy read)."""
    pos: np.ndarray        # (N, 3) f32
    vel: np.ndarray        # (N, 3) f32
    mass: np.ndarray       # (N,) f32
    split: tuple           # (n_gas, n_dark, n_star), file order
    centers: np.ndarray    # (G, 3) f32
    rgtp: np.ndarray       # (G,) f32
    gtp_mass: np.ndarray   # (G,) f32

    @property
    def n(self) -> int:
        return self.mass.shape[0]

    @property
    def n_halos(self) -> int:
        return self.centers.shape[0]


def clump_sizes(n_particles: int, n_halos: int, size_seed: int) -> np.ndarray:
    """bench.make_box's clump sizes for numpy's generator at ``size_seed``
    (its first draw): Lomax(1.5) + 1, scaled to n // 2, floor 24."""
    rng = np.random.default_rng(size_seed)
    sizes = rng.pareto(1.5, n_halos) + 1.0
    n_clumped = n_particles // 2
    return np.maximum((sizes / sizes.sum() * n_clumped).astype(np.int64), 24)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2 ** 63 - 1))
    return g


def _uniform(g, shape, lo, hi, device, dtype=torch.float32):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                       dtype=dtype)


def snapshot(config: dict, mix: dict, seed: int, device) -> Snapshot:
    """The configuration's box under the traffic mix, from ``seed``."""
    device = torch.device(device)
    n_req, G = int(config["n_particles"]), int(config["n_halos"])
    sizes = clump_sizes(n_req, G, int(config["size_seed"]))
    rmax = (0.0012 * sizes.astype(np.float64) ** (1 / 3)).astype(np.float32)
    rgtp = np.maximum(rmax, np.float32(0.001)).astype(np.float32)
    g = generator(seed, device)
    with torch.no_grad():
        centers = _uniform(g, (G, 3), -0.5, 0.5, device)
        n_bg = n_req - n_req // 2
        bg = _uniform(g, (n_bg, 3), -0.5, 0.5, device)
        sz = torch.as_tensor(sizes, device=device)
        halo = torch.repeat_interleave(torch.arange(G, device=device), sz)
        r = (torch.as_tensor(rmax, device=device)[halo]
             * _uniform(g, halo.shape, 0.001, 1.0, device))
        u = torch.randn((halo.shape[0], 3), generator=g, device=device)
        u = u / torch.linalg.vector_norm(u, dim=1, keepdim=True)
        p = centers[halo] + r[:, None] * u
        del r, u
        p = (p + 0.5) % 1.0 - 0.5
        pos = torch.cat([bg, p])
        del bg, p
        v = config["velocities"]
        bulk = v["bulk"] * torch.randn((G, 3), generator=g, device=device)
        vel = torch.randn((pos.shape[0], 3), generator=g, device=device)
        vel[:n_bg] *= v["background"]
        vel[n_bg:] *= v["internal"]
        vel[n_bg:] += bulk[halo]
        del bulk, halo
        n = pos.shape[0]
        masses = mix["mass"]
        if masses["kind"] == "uniform":
            mass = torch.full((n,), 1.0 / n, dtype=torch.float32,
                              device=device)
        elif masses["kind"] == "range":
            mass = (_uniform(g, (n,), masses["lo"], masses["hi"], device,
                             torch.float64) / n).to(torch.float32)
        else:
            raise ValueError(f"unknown mass kind {masses['kind']!r}")
        sp = mix.get("species_split")
        if sp:
            # species by file position; one permutation mixes them in space
            perm = torch.randperm(n, generator=g, device=device)
            pos, vel = pos[perm], vel[perm]
            del perm
            n_gas = int(n * sp["gas"][0] // sp["gas"][1])
            n_star = int(n * sp["star"][0] // sp["star"][1])
            split = (n_gas, n - n_gas - n_star, n_star)
        else:
            split = (0, n, 0)
        cat = mix["gtp_mass"]
        if cat["kind"] != "clump":
            raise ValueError(f"unknown catalog mass kind {cat['kind']!r}")
        jit = float(cat["jitter"])
        gtp_mass = (torch.as_tensor(sizes, dtype=torch.float64, device=device)
                    * (mass.to(torch.float64).sum() / n)
                    * _uniform(g, (G,), 1.0 - jit, 1.0 + jit, device,
                               torch.float64)).to(torch.float32)
        out = Snapshot(pos=pos.cpu().numpy(), vel=vel.cpu().numpy(),
                       mass=mass.cpu().numpy(), split=split,
                       centers=centers.cpu().numpy(), rgtp=rgtp,
                       gtp_mass=gtp_mass.cpu().numpy())
    return out
