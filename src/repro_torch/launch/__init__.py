"""Entry points: LM serving (``python -m repro_torch.launch.serve``) and
online RDF serving (``python -m repro_torch.launch.serve_rdf``)."""
