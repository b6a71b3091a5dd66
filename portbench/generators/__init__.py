"""The general generators, one per kind of traffic: ``store`` (the feature
store over PNG files) and ``train`` (the trainer's graphed epochs over a
cached bank).  A traffic file names its generator under ``generator`` and
holds every parameter it reads; ``run(ctx)`` sets up, measures, compares and returns a ``Result``."""
