"""Images a coalesced batch over the window: ``MicroBatcher.n_images`` over
``n_batches``, both taken as differences across the window."""


def read(readings, trace):
    batches = readings.get("batcher_batches")
    if not batches:
        return None
    return readings["batcher_images"] / batches
