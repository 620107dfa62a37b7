"""``bucket_padding_efficiency``: useful over padded rows the bucketed
batch shipped to the device in the window (the port's
``jtpu_bucket_ops_total``)."""


def read(ctx):
    c = ctx["counters"]
    if not c["bucket_padded"]:
        return None
    return c["bucket_useful"] / c["bucket_padded"]
