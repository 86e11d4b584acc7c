"""Hand-written CUDA kernels of the port: build (``kernels.build``) and the
launch counts that show a run went through them.

``LAUNCHES[name]`` is raised by one at each launch of kernel ``name`` by its
wrapper, and nowhere else.
"""

from collections import Counter

LAUNCHES: Counter = Counter()
