"""The analysis CLIs of the port: one module per root ``plot_*.py`` script
of the repository, under the same file name, and the sweep runner
``multi_experiments``. Each runs as

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.<name> <flags>

with the root script's flags and output (lines, files under
``--output_path``), and each is ``main(cfg, device=None)``: on CUDA device
``--cuda`` by default, raising where there is none; ``device="cpu"`` runs
the plain PyTorch path. ``matplotlib`` and ``sklearn`` are imported only
where a plot or a t-SNE is made."""
