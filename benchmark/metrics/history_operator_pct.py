"""The share of the traced window's ``step`` spans under which the program
counted ``history_operator`` (the step's right-hand side as the history
operator's product ``b0 + B h`` in place of the element assembly), in %.

None where there is nothing to read, and where the program has no history
operator (``ops/assembly.assemble_history_operator``): a tree before it
never counts it."""

from harness import program_spans


def _program_has_it():
    try:
        from fenicssolver_tpu_torch.ops import assembly
    except ImportError:
        return False
    return hasattr(assembly, "assemble_history_operator")


def read(run):
    ps = program_spans.read(run)
    steps = ps.named("step") if ps is not None else None
    if not steps or not _program_has_it():
        return None
    on = {ps.by_id[c.span].root for c in ps.counts
          if c.name == "history_operator" and c.span in ps.by_id}
    return 100.0 * sum(s.id in on for s in steps) / len(steps)
