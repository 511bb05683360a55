"""Quality assessment: RMSE, PSNR, SSIM and LPIPS per frame, with
incremental CSVs, QA_Scores.json and scene-wise grouping
(`qa.runner.run_all_qa`, `python -m vipnerf_tpu_torch.qa.runner`)."""
