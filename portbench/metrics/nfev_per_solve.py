"""Forward evaluations per inversion (the rows minimize_lm counts), mean
over the window's inversions (program counter)."""


def read(run):
    n = run.field("nfev")
    return sum(n) / len(n) if n else None
