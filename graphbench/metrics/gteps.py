"""Graph500 TEPS over the whole window, in 1e9 edges/s: the input edges
inside the component each completed search reached, summed over the
searches, over the window's seconds."""


def read(run):
    edges = [it["edges"] for it in run.window.items if "edges" in it]
    if not edges:
        return None
    return sum(edges) / run.window.seconds / 1e9
