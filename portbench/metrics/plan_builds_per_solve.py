"""Plans the engine built per inversion (Engine.plan_builds, each stages
a GF window on the card), mean over the window's inversions."""


def read(run):
    n = run.field("plan_builds")
    return sum(n) / len(n) if n else None
