"""Interactions aggregate (Interactions.h:9-24): IPC contact with lagged
friction, and the attachments.

Port of `stark_tpu/models/interactions/interactions.py`. The attachments
are built after the contact model, as JAX builds them: the registration
order sets the order of the energy sum.
"""
from __future__ import annotations

from .attachments import EnergyAttachments
from .contact import EnergyFrictionalContact


class Interactions:
    def __init__(self, stark, dyn, rb_dyn):
        self.contact = EnergyFrictionalContact(stark, dyn, rb_dyn)
        self.attachments = EnergyAttachments(stark, dyn, rb_dyn)

    def freeze(self, layout, dtype, device):
        self.contact.freeze(layout, dtype, device)

    def dynamic_family_data(self):
        return self.contact.dynamic_family_data()

    def glob_entries(self):
        return self.contact.glob_entries()
