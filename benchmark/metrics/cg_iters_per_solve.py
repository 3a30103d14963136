"""CG iterations a linear solve (``solver.last_iterations``, or the count
that ``la/krylov.cg`` returns), the mean over the window."""


def read(run):
    values = run.counter("iterations")
    return None if values is None else sum(values) / len(values)
