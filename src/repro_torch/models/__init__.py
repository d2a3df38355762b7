"""Language-model substrate (counterpart of ``repro/models``): layers,
recurrent blocks (kernel B4), attention (kernel B5) and the hybrid
(Zamba2) model assembly."""
