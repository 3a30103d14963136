"""The Krylov solve's synchronised wall (``solver.timers`` "krylov", or the
benchmark's clock around ``la/krylov.cg``) over its iterations: ms a
preconditioned CG iteration, the GMG V-cycle included."""


def read(run):
    seconds, iters = run.counter("krylov_s"), run.counter("iterations")
    if seconds is None or iters is None or sum(iters) == 0:
        return None
    return 1e3 * sum(seconds) / sum(iters)
