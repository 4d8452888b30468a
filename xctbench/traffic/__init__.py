"""Traffic: the inputs a cell sends, made from the seed.

``<traffic>.json`` beside this file holds one mix's parameters; the one
generator, ``slabs``, reads them.
"""
