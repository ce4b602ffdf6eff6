"""A zoom snapshot made on the device from a seed: one host halo that
holds about a third of the particles, field halos and a background.

The shape is so_tpu's ``chip_smoke.giant_config`` (one r^-2 clump with
four near-coincident catalog centers, and small centers about the box)
at the sizes of the configuration file:

- the host: ``n_host`` particles at r = ``host_rmax`` * U(``host_r_min``,
  1) along random directions about a center drawn from the seed (so
  M(<r) grows as r), and one catalog center at each of ``host_offsets``
  from it, each with Rgtp ``host_rgtp``;
- the field: ``make_box.snapshot`` at twice ``n_field`` particles and
  ``n_field_halos`` centers, so its clumps hold ``n_field`` particles
  (bench.make_box's Lomax(1.5) + 1 sizes, floor 24, drawn from
  ``size_seed``) and its background as many; its Rgtp is make_box's,
  capped at ``field_rgtp_max``, so that a host center is the catalog's
  largest;
- the rest of ``n_particles`` a uniform background.

Velocities follow make_box's rule (the configuration's ``velocities``):
the host moves with a bulk velocity of its own and its particles add the
internal spread. Masses and catalog masses are drawn over the whole box
as make_box draws them (the mix's ``mass``; ``gtp_mass`` "clump": each
center's clump count, the host's for the host centers, times the mean
particle mass times U(1 - jitter, 1 + jitter)). File order: the field's
background and clumps, the host, the rest of the background.
"""

from __future__ import annotations

import numpy as np
import torch

from sobench.gen import make_box

HOST_STREAM = 1 << 62      # the host's draws: a stream apart from make_box's


def field_sizes(config: dict) -> np.ndarray:
    """The field clumps' particle counts (make_box's at ``size_seed``)."""
    return make_box.clump_sizes(2 * int(config["n_field"]),
                                int(config["n_field_halos"]),
                                int(config["size_seed"]))


def _masses(mix: dict, n: int, g, device) -> torch.Tensor:
    masses = mix["mass"]
    if masses["kind"] == "uniform":
        return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    if masses["kind"] == "range":
        return (make_box._uniform(g, (n,), masses["lo"], masses["hi"],
                                  device, torch.float64) / n
                ).to(torch.float32)
    raise ValueError(f"unknown mass kind {masses['kind']!r}")


def snapshot(config: dict, mix: dict, seed: int, device) -> make_box.Snapshot:
    """The configuration's zoom box under the traffic mix, from ``seed``."""
    if mix.get("species_split"):
        raise ValueError("the giant box is dark matter only")
    device = torch.device(device)
    n_host = int(config["n_host"])
    # the field's positions, velocities, centers and Rgtp; its masses and
    # catalog masses are drawn again below over the whole box
    field = make_box.snapshot(
        dict(config, n_particles=2 * int(config["n_field"]),
             n_halos=int(config["n_field_halos"])),
        dict(mix, mass={"kind": "uniform"}), seed, device)
    n = int(config["n_particles"])
    n_bg = n - field.n - n_host
    if n_bg < 0:
        raise ValueError("n_particles is below the host and the field")
    offsets = np.asarray(config["host_offsets"], np.float32)
    g = make_box.generator(int(seed) + HOST_STREAM, device)
    v = config["velocities"]
    with torch.no_grad():
        c = make_box._uniform(g, (3,), -0.5, 0.5, device)
        r = float(config["host_rmax"]) * make_box._uniform(
            g, (n_host, 1), float(config["host_r_min"]), 1.0, device)
        u = torch.randn((n_host, 3), generator=g, device=device)
        u = u / torch.linalg.vector_norm(u, dim=1, keepdim=True)
        host = (c + r * u + 0.5) % 1.0 - 0.5
        del r, u
        bg = make_box._uniform(g, (n_bg, 3), -0.5, 0.5, device)
        vel = torch.randn((n_host + n_bg, 3), generator=g, device=device)
        vel[:n_host] *= v["internal"]
        vel[:n_host] += v["bulk"] * torch.randn((3,), generator=g,
                                                device=device)
        vel[n_host:] *= v["background"]
        centers = (c[None, :] + torch.as_tensor(offsets, device=device)
                   + 0.5) % 1.0 - 0.5
        mass = _masses(mix, n, g, device)
        cat = mix["gtp_mass"]
        if cat["kind"] != "clump":
            raise ValueError(f"unknown catalog mass kind {cat['kind']!r}")
        jit = float(cat["jitter"])
        G = offsets.shape[0] + field.n_halos
        sizes = np.concatenate([np.full(offsets.shape[0], n_host),
                                field_sizes(config)])
        gtp_mass = (torch.as_tensor(sizes, dtype=torch.float64, device=device)
                    * (mass.to(torch.float64).sum() / n)
                    * make_box._uniform(g, (G,), 1.0 - jit, 1.0 + jit,
                                        device, torch.float64)
                    ).to(torch.float32)
        pos = np.concatenate([field.pos, host.cpu().numpy(),
                              bg.cpu().numpy()])
        del host, bg
        vel = np.concatenate([field.vel, vel.cpu().numpy()])
        rgtp = np.concatenate([
            np.full(offsets.shape[0], config["host_rgtp"], np.float32),
            np.minimum(field.rgtp, np.float32(config["field_rgtp_max"]))])
        return make_box.Snapshot(
            pos=pos, vel=vel, mass=mass.cpu().numpy(), split=(0, n, 0),
            centers=np.concatenate([centers.cpu().numpy(), field.centers]),
            rgtp=rgtp, gtp_mass=gtp_mass.cpu().numpy())
