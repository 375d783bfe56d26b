"""Fine-grid cells the device discretizer solved in the window, per model:
the program's `eik.fine_cells` counter (batch x the padded fine grid of
each device discretization), its difference around each call
(drivers/eikonal_grid.py), over the models those calls answered; none
where the program lacks it."""


def read(run):
    recs = [r for r in run.records if "eik.fine_cells" in r]
    units = sum(r["units"] for r in recs)
    return sum(r["eik.fine_cells"] for r in recs) / units if units else None
