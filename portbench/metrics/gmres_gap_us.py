"""Microseconds the card idles between the end of an iteration's CGS2 and
the next iteration's apply: the mean of the program's `gmres.gap` CUDA
event pairs, in the sub-window with the program's tracing on and no
profiler (`portbench/program.py`). None off the card."""

from portbench import program


def read(run):
    block = program.windows(run)
    gap = (block or {}).get("gaps", {}).get("gmres.gap")
    if not gap or gap["pairs"] <= 0:
        return None
    return 1e6 * gap["total_s"] / gap["pairs"]
