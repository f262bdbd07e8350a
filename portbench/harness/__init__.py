"""The benchmark's own code: the manifest, the drivers of each kind of
traffic, the profiler reading, and the frozen arithmetic (store cost, model
FLOPs, peaks) that later changes to the program cannot move.

Nothing here imports the program at module level: a driver imports
``repro_torch`` inside the function that runs a cell, after ``run.py`` has
put the checkout's ``src`` on the path.
"""
