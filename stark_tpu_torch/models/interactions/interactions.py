"""Interactions aggregate (Interactions.h:9-24): IPC contact with lagged
friction.

Attachments are ROADMAP Queue 1 P8: `interactions.attachments` raises.
"""
from __future__ import annotations

from .contact import EnergyFrictionalContact


class Interactions:
    def __init__(self, stark, dyn, rb_dyn):
        self.contact = EnergyFrictionalContact(stark, dyn, rb_dyn)

    @property
    def attachments(self):
        raise NotImplementedError("attachments are not ported yet (ROADMAP Queue 1 P8)")

    def freeze(self, layout, dtype, device):
        self.contact.freeze(layout, dtype, device)

    def glob_entries(self):
        return self.contact.glob_entries()
