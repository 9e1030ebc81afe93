"""Blocks a Long-CLIP step runs again in backward (the counter
``longclip.recomputed_blocks``) per step of the traced window (the counter
``longclip.steps``), from the program's table as ``step_table.py`` reads
it.  None where the program has no table, or the table lacks either
counter, or counted no step."""


def read(run):
    try:
        from egm_unet_torch.utils.profiling import table
    except ImportError:
        return None
    tab = table()
    steps = tab.get("longclip.steps", {}).get("value")
    blocks = tab.get("longclip.recomputed_blocks", {}).get("value")
    if not steps or blocks is None:
        return None
    return blocks / steps
