"""K9's share of its roofline in the regenerating step: the least time the
card could take for its work a sample pass over ``k9_ms.train``'s device
time a pass, in percent. K9 is bound by bytes: each realized residual slot
read once (13 floats, 52 B), and per lane its radiance cotangent (3
floats), its count and lane id (2 words) read and its S x 10 rows of
d_state0 written, over the published HBM bandwidth of one H100
(``bounds.PEAK_BYTES_PER_S``). The slots are the program's
``k4.replay_slots`` counter; the lanes every pixel's K first-bounce lanes.
None where the program counts no replay slots."""

from portbench import bounds, spans

SLOT_BYTES = 13 * 4
LANE_BYTES = 3 * 4 + 2 * 4
STATE0_ROW_BYTES = 10 * 4  # a sample's d_state0 rows of one lane


def bytes_per_pass(slots_per_pass: float, lanes: int, s_count: int) -> float:
    """The bytes K9 must move a sample pass: its slots, and each lane's
    inputs and S x 10 d_state0 rows once a step."""
    return slots_per_pass * SLOT_BYTES + lanes * (LANE_BYTES + STATE0_ROW_BYTES * s_count) / s_count


def install(ctx):
    return spans.install(ctx)


def value(ctx, tracing):
    got = spans.window(ctx, tracing, spans.STEP)
    if got is None:
        return None
    slots = got[1].get("k4.replay_slots")
    ms = spans.kernel_ms(ctx, "pt3.k9", spans.STEP)
    if slots is None or not ms:
        return None
    cfg, tr = ctx.config, ctx.traffic
    lanes = tr["width"] * tr["height"] * cfg["first_bounce_u"] * cfg["first_bounce_v"]
    least_ms = bytes_per_pass(slots / ctx.units, lanes, tr["passes_per_step"]) \
        / bounds.PEAK_BYTES_PER_S * 1e3
    return 100.0 * least_ms / ms
