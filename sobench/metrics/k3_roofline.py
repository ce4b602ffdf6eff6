"""Kernel K3's share of its roofline: the least time its launches could
take, K3.bytes / 3.35 TB/s (one H100 SXM's device memory bandwidth, the
data sheet, at a 700 W power limit; the result line gives the card's
limit), over the device time of piece_gather_kernel, in percent.

K3.bytes is ops/gather.count_gather_bytes' count over a rerun of the
traced window's jobs with the device counts on (program_spans.counted:
the traced window itself counts no bytes, so nothing is added to what
the card runs there), per launch: 12 B for each distinct payload row its
runs put below K (once however many of its balls hold it), 4 B for each
of the five int32 fields of each live piece descriptor and for each
halo's count, and 4 B x B x K for d2, for each channel and for idx if
asked, written once. The channels' rows read at in-ball rows are left
out, so the share is a floor."""

from sobench import program_spans

install = program_spans.install


def read(record):
    return program_spans.roofline_pct(record, "K3.bytes",
                                      ("piece_gather_kernel",))
