"""The plain reference agrees with the program where both compute in
float32: the field with the program's nn.Module, and whole training steps
(on the random numbers the program drew, known by their role) and
renders, with the program's own entries."""

import pytest
import torch
from harness import reference, runner, scene, spec


def test_the_reference_field_is_the_programs_module(tiny):
    from nerfmeshes_tpu_torch.models import build_model

    cell = tiny("lego.train", compute_dtype="float32")
    cfg = spec.program_cfg(cell, 7)
    weights = scene.initial_weights(cfg["models"], 7, "cpu")
    model = build_model("FlexibleNeRFModel", cfg["models"]["fine"])
    model.load_state_dict({k[len("fine."):]: v for k, v in weights.items()
                           if k.startswith("fine.")})
    gen = torch.Generator().manual_seed(0)
    points = torch.rand((500, 3), generator=gen) * 4.0 - 2.0
    dirs = torch.nn.functional.normalize(torch.randn((500, 3), generator=gen), dim=-1)
    rgb, sigma = reference.field({k[len("fine."):]: v for k, v in weights.items()
                                  if k.startswith("fine.")}, cfg["models"]["fine"], points, dirs)
    out = model(points, dirs)
    torch.testing.assert_close(rgb, out[:, :3], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(sigma, out[:, 3], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("name", ["lego.train", "llff.train", "lego.render", "llff.render"])
def test_the_reference_follows_a_float32_run_of_the_program(tiny, name):
    cell = tiny(name, compute_dtype="float32")
    cell.config["cfg"]["experiment"]["use_fused_kernel"] = False
    outcome = runner.run_outcome(cell, 2**31 + 11, 0.3, False, device="cpu")
    got = {k: v for k, v, _ in outcome.checks}
    assert outcome.attempted > 0
    if cell.kind == "train":
        assert got["coarse_median_gap"] < 1e-6 and got["fine_median_gap"] < 1e-6
        assert got["loss_gap"] < 1e-4 and got["grad_gap"] < 1e-4 and got["loss_map_gap"] < 1e-6
    else:
        assert got["rgb_max_gap"] < 1e-5


def test_the_draws_are_known_by_role_not_by_order(tiny):
    """The reference takes a step's random numbers by their distribution
    and shape: the same numbers drawn in another order, or the PDF's
    uniforms made as exponential spacings, give the same step."""
    cfg = spec.program_cfg(tiny("llff.train"), 3)  # num_coarse == num_fine
    rays, Sc, Nf = 16, cfg["nerf"]["train"]["num_coarse"], cfg["nerf"]["train"]["num_fine"]
    gen = torch.Generator().manual_seed(5)
    img, pix = torch.tensor(2), torch.randint(0, 192, (rays,), generator=gen)
    strata, pdf = torch.rand((rays, Sc), generator=gen), torch.rand((rays, Nf), generator=gen)
    noise_c, noise_f = torch.randn((rays, Sc), generator=gen), torch.randn((rays, Sc + Nf),
                                                                          generator=gen)
    drawn = [("int", img), ("int", pix), ("uniform", strata), ("normal", noise_c),
             ("uniform", pdf), ("normal", noise_f)]
    shuffled = [drawn[i] for i in (5, 1, 3, 0, 2, 4)]
    for records in (drawn, shuffled):
        got_img, got_pix, draws = reference.assign_draws(records, cfg, rays)
        assert int(got_img) == 2 and torch.equal(got_pix, pix)
        assert torch.equal(draws.strata, strata) and torch.equal(draws.noise_fine, noise_f)
        assert torch.equal(draws.noise_coarse, noise_c)
        assert torch.equal(draws.pdf, torch.sort(pdf, dim=-1).values)
    spacings = torch.empty((rays, Nf + 1)).exponential_(generator=gen)
    records = drawn[:4] + [("exponential", spacings)] + drawn[5:]
    _, _, draws = reference.assign_draws(records, cfg, rays)
    cums = torch.cumsum(spacings.double(), dim=-1)
    torch.testing.assert_close(draws.pdf, (cums[:, :-1] / cums[:, -1:]).float())
    assert bool((draws.pdf[:, 1:] >= draws.pdf[:, :-1]).all())
    with pytest.raises(ValueError, match="fine noise"):
        reference.assign_draws(drawn[:5], cfg, rays)


def test_a_program_that_draws_in_another_order_and_stream_is_followed(tiny, monkeypatch):
    """The program's batch draws moved: the pixels before the image, and
    one draw spent first, so every later number of the stream moves too.
    The reference follows the numbers the program drew."""
    from nerfmeshes_tpu_torch.train import step as step_module

    def reordered(generator, num_images, H, W, num_rays, *, sample_all_images=False,
                  device=None, pixel_generator=None):
        torch.rand((), generator=generator, device=device)
        pix = torch.randint(0, H * W, (num_rays,), generator=generator, device=device)
        img = torch.randint(0, num_images, (), generator=generator, device=device)
        return img, pix

    monkeypatch.setattr(step_module, "draw_ray_indices", reordered)
    cell = tiny("llff.train", compute_dtype="float32")
    cell.config["cfg"]["experiment"]["use_fused_kernel"] = False
    outcome = runner.run_outcome(cell, 2**31 + 12, 0.3, False, device="cpu")
    got = {k: v for k, v, _ in outcome.checks}
    assert got["coarse_median_gap"] < 1e-6 and got["fine_median_gap"] < 1e-6
    assert got["loss_gap"] < 1e-4 and got["grad_gap"] < 1e-4 and got["loss_map_gap"] < 1e-6
