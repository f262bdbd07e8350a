"""``edit.wall_s``: every edit's wall, from the call of ``Workspace.run`` to
the card's synchronisation after it, over the number of edits."""


def read(run):
    if not run.edits:
        return None
    return sum(e["wall_s"] for e in run.edits) / len(run.edits)
