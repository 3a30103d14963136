"""100 x the device's busy time inside the program's ``assembly`` spans
(``ops/assembly``, each synchronised at both ends, so it bounds the
assembly's device work) over their wall, in the traced window."""

from harness import program_spans


def read(run):
    ps = program_spans.read(run, device=True)
    if ps is None:
        return None
    busy, wall = ps.busy_share("assembly")
    return 100.0 * busy / wall if wall > 0 else None
