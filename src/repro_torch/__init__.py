"""PyTorch/CUDA port of the GraphScope Flex reproduction.

Serves Cypher and Gremlin read queries through
:class:`repro_torch.serving.QueryService`; the fragment route runs its
frontier hops, shortest-path relaxations and device tail on hand-written
CUDA kernels (``repro_torch.kernels``). Entry points run on the GPU unless
the caller passes ``device="cpu"``.
"""
