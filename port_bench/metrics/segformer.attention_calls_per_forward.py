"""Spatial-reduction attention calls (the counter
``segformer.attention_calls``) per SegFormer forward of the traced window
(the counter ``segformer.forwards``), from the program's table.  None where
the program has no table, or the table lacks either counter, or counted no
forward."""


def read(run):
    try:
        from egm_unet_torch.utils.profiling import table
    except ImportError:
        return None
    tab = table()
    forwards = tab.get("segformer.forwards", {}).get("value")
    calls = tab.get("segformer.attention_calls", {}).get("value")
    if not forwards or calls is None:
        return None
    return calls / forwards
