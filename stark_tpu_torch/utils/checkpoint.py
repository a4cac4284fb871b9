"""Simulation state checkpoint / resume.

Port of `stark_tpu/utils/checkpoint.py`, with its npz keys and meta: the
deformable x0/v0, the rigid t0/q0/v0/w0, the clock, the adaptive dt and the
hardening states (contact stiffness, prescribed and per-constraint
stiffness). A checkpoint written by either package loads into the other.
Like the JAX package's, it does not carry the attachments' hardened
stiffness (ROADMAP Queue 3 records this as shared with the reference).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .. import maths

CONSTRAINTS = ("global_points", "global_directions", "points", "point_on_axes", "distances",
               "distance_limits", "directions", "angle_limits", "damped_springs",
               "linear_velocity", "angular_velocity")


def save_state(sim, path: str):
    dyn = sim._dyn
    rb = sim._rb_dyn
    contact = sim.interactions.contact
    arrays = {
        "pt_x0": dyn.x0.cpu().numpy() if dyn.frozen else dyn._x0_host,
        "pt_v0": dyn.v0.cpu().numpy() if dyn.frozen else dyn._v0_host,
        "rb_t0": rb.t0, "rb_q0": rb.q0, "rb_v0": rb.v0, "rb_w0": rb.w0,
    }
    meta = {
        "current_time": sim.stark.current_time,
        "current_frame": sim.stark.current_frame,
        "current_time_step": sim.stark.current_time_step,
        "dt": sim.stark.dt,
        "next_frame_time": sim.stark.next_frame_time,
        "contact_stiffness": contact.contact_stiffness,
        "prescribed_stiffness": sim.deformables.prescribed_positions.stiffness,
        "constraint_stiffness": {
            name: list(getattr(sim.rigidbodies.constraints, name).stiffness)
            for name in CONSTRAINTS
        },
    }
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_state(sim, path: str):
    """Restore a checkpoint into `sim`; after the first step (frozen) the
    point state goes onto the simulation's device in its dtype."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    dyn = sim._dyn
    rb = sim._rb_dyn
    if dyn.frozen:
        dtype, device = sim.stark.dtype, sim.stark.device
        dyn.x0 = torch.as_tensor(data["pt_x0"], dtype=dtype, device=device)
        dyn.x1 = dyn.x0
        dyn.v0 = torch.as_tensor(data["pt_v0"], dtype=dtype, device=device)
        dyn.v1 = torch.zeros_like(dyn.v0)
        # refresh the post-freeze host mirrors (the solver-primed caches would
        # otherwise serve the state from before the restore)
        dyn._host_x0 = np.asarray(data["pt_x0"], dtype=np.float64).copy()
        dyn._host_x1 = None
        dyn._host_v1 = None
    else:
        dyn._x0_host = data["pt_x0"].copy()
        dyn._v0_host = data["pt_v0"].copy()
    rb.t0 = data["rb_t0"].copy()
    rb.t1 = rb.t0.copy()
    rb.q0 = data["rb_q0"].copy()
    rb.q1 = rb.q0.copy()
    rb.R0 = maths.np_quat_to_rotation(rb.q0)
    rb.R1 = rb.R0.copy()
    rb.v0 = data["rb_v0"].copy()
    rb.w0 = data["rb_w0"].copy()
    st = sim.stark
    st.current_time = meta["current_time"]
    st.current_frame = meta["current_frame"]
    st.current_time_step = meta["current_time_step"]
    st.dt = meta["dt"]
    st.next_frame_time = meta["next_frame_time"]
    sim.interactions.contact.contact_stiffness = meta["contact_stiffness"]
    pp = sim.deformables.prescribed_positions
    pp.stiffness = list(meta["prescribed_stiffness"])
    if pp.stiffness:
        st.mark_dirty(pp.NAME)
    for name, ks in meta["constraint_stiffness"].items():
        cont = getattr(sim.rigidbodies.constraints, name)
        cont.stiffness = list(ks)
        if ks:
            cont.mark_dirty()
