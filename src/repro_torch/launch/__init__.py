"""Entry points: LM serving (``python -m repro_torch.launch.serve``), online
RDF serving (``python -m repro_torch.launch.serve_rdf``), and the localhost
multi-process launcher (``python -m repro_torch.launch --nprocs N --device
cpu|cuda script.py``; ``multihost.py`` holds the process-group bring-up
that ``DistributedSubstrate`` uses)."""
