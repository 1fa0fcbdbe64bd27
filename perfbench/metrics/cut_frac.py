"""The cut weight over the total edge weight, averaged over the window's
calls (which cover each input of the pool equally often)."""


def read(run):
    xs = run.series.get("cut_frac")
    if run.loop != "partition" or not xs:
        return None
    return sum(xs) / len(xs)
