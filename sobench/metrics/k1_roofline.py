"""Kernel K1's share of its roofline: the least time its launches could
take, K1.bytes / 3.35 TB/s (one H100 SXM's device memory bandwidth, the
data sheet, at a 700 W power limit; the result line gives the card's
limit), over the device time of slab_gather_kernel and
slab_gather_sorted_kernel, in percent.

K1.bytes is ops/gather.count_gather_bytes' count over a rerun of the
traced window's jobs with the device counts on (program_spans.counted:
the traced window itself counts no bytes, so nothing is added to what
the card runs there), per launch of either form: 12 B for each distinct
payload row its runs put below K (once however many of its balls hold
it), 4 B for each of the three int32 fields of each live chunk
descriptor and for each halo's count, 4 B x B x K for d2, for each
channel and for idx if asked, written once, and for the sorted form 8 B
for each halo's in-ball count. The channels' rows read at in-ball rows
are left out, so the share is a floor."""

from sobench import program_spans

install = program_spans.install

KERNELS = ("slab_gather_kernel", "slab_gather_sorted_kernel")


def read(record):
    return program_spans.roofline_pct(record, "K1.bytes", KERNELS)
