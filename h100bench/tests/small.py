"""Small versions of the benchmark's cells that a CPU test run holds: the
same decks and traffic at a few thousand cells."""

from __future__ import annotations

from h100bench import spec

SMALL = {"disk_sph": {"nx1": 32, "nx2": 16, "nx3": 16, "x1min": 0.4, "x1max": 2.4},
         "disk_rhd_amr": {"nx1": 32, "nx2": 32, "nx3": 8}}
CELLS = ("disk_sph.uniform", "disk_rhd_amr.uniform")


def small_cell(name):
    """The cell ``name`` with its mesh cut to a CPU test's size."""
    cell = spec.load_cell(name)
    deck = {b: dict(kv) for b, kv in cell.config["deck"].items()}
    deck["parthenon/mesh"].update(SMALL[cell.entry["config"]])
    cell.config = dict(cell.config, deck=deck)
    return cell


def small_tree():
    """disk_rhd_amr as its deck is written, with its static refinement
    patch (the uniform cell without the traffic's overrides), cut to a CPU
    test's size."""
    cell = small_cell("disk_rhd_amr.uniform")
    cell.traffic = dict(cell.traffic, overrides={})
    return cell


def on_the_cards_path(monkeypatch):
    """Make the port's refinement trees take the fused path on the CPU (its
    plain version), the path they take on the card; the reference's tree
    takes it wherever its gates pass."""
    from artemis_tpu_torch import amr

    compile_ = amr.MultiLevelSMR._compile
    monkeypatch.setattr(amr.MultiLevelSMR, "_compile",
                        lambda self, fused, gather6=True: compile_(self, True, gather6))
