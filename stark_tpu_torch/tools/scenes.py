"""Scenes the on-card scripts drive (`chip_smoke.py`, `tools/profile_stages.py`)."""
from __future__ import annotations

import math


def spinning_box_cloth(n: int, dtype: str, device: str = "cuda",
                       adaptive: bool = True, name: str = "spinning_box_cloth",
                       mu: float = 0.0, broad_phase: str = "auto"):
    """bench.py's spinning_box_cloth: an n x n Cotton_Fabric cloth (0.4 m)
    falling on a fixed 8 cm box that sinks and turns (90 deg/s), IPC contact
    at 2 mm thickness. With mu > 0, Coulomb friction mu between the cloth
    and the box and of the cloth with itself (the upstream examples' cloth
    friction is 1.0). `broad_phase` ("auto", "dense", "grid") picks the
    candidate search; "auto" takes the hash grid for the edge-edge block
    from 62x62 on. Returns (sim, cloth handler, spin(t)); the caller either
    registers spin as a time event or calls it before each step."""
    from stark_tpu_torch import Settings, Simulation
    from stark_tpu_torch.models.interactions.contact import ContactGlobalParams
    from stark_tpu_torch.presets.presets import SurfaceParams

    s = Settings()
    s.output.simulation_name = f"{name}_{n}"
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.device = device
    s.device.dtype = dtype
    s.simulation.use_adaptive_time_step = adaptive
    sim = Simulation(s)
    gp = ContactGlobalParams()
    gp.default_contact_thickness = 0.002
    sim.interactions.contact.set_global_params(gp)
    sim.interactions.contact.broad_phase = broad_phase
    cloth = sim.presets.deformables.add_surface_grid(
        "cloth", (0.4, 0.4), (n, n), SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_translation([0.0, 0.0, -0.08])
    fix = sim.rigidbodies.add_constraint_fix(box.rigidbody)
    if mu > 0.0:
        cloth.contact.set_friction(box.contact, mu)
        cloth.contact.set_friction(cloth.contact, mu)

    def spin(t):
        fix.set_transformation([0.0, 0.0, -0.08 - 0.1 * math.sin(t)],
                               angle_deg=90.0 * t, axis=[0.0, 0.0, 1.0])

    return sim, cloth, spin
