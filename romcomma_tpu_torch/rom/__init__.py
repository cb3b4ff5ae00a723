from romcomma_tpu_torch.rom.rom import ROM, run_rom  # noqa: F401
