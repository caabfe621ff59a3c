"""Helpers of the harness tests."""


def small_cell(name: str, h: int = 300, w: int = 240):
    """The cell `name` at a size a CPU test can hold."""
    from benchmark.harness import load_cell

    cell = load_cell(name)
    p = cell.params
    p.update(height=h, width=w)
    if "corpus" in p:
        p.update(corpus=2, chunk=2, warm_chunks=1, sample_one_in=1)
    else:
        p.update(batch=2, distinct_batches=2, warm_calls=1, compare_within=2)
    return cell
