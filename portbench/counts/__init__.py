"""Operation and byte counts of the benchmark's rooflines, from shapes alone.

Every function here takes sizes and returns seconds or counts: it reads the
work the algorithm needs, whatever implements it, so a later change of a
kernel leaves its count where it is.  ``peaks`` holds the card's published
rates; ``fit`` and ``kmeans`` the counts of the two entries.
"""
