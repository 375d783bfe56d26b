"""Mean seconds of one inversion over every inversion the window completed
(host clock around each, from its start row to its final misfit)."""


def read(run):
    t = run.field("t")
    return sum(t) / len(t)
