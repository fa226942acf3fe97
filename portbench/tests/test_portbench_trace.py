"""The traced segment's reduction on a made-up trace: busy time as a union,
idle gaps named by the host operation that overlaps them most, device time
by the port's wrapper, kernels counted apart from copies."""

import pytest

from portbench import trace


def test_reduce_on_a_made_up_segment():
    evts = [  # (name, on the device, user annotation, start us, end us)
        (trace.SEGMENT, False, True, 0.0, 100.0),
        ("aten::linear", False, False, 0.0, 30.0),
        ("Optimizer.step#Adam.step", False, False, 40.0, 90.0),
        ("aten::mul", False, False, 60.0, 70.0),
        ("void (anonymous namespace)::sa_mlp_max_kernel<float>(float const*, int)",
         True, False, 10.0, 30.0),
        ("(anonymous namespace)::sa_group_kernel(float const*, int)", True, False, 25.0, 40.0),
        ("Memcpy HtoD (Pageable -> Device)", True, False, 55.0, 60.0),
        ("void at::native::reduce_kernel<128, 4>(float*)", True, False, 95.0, 110.0),
        (trace.SEGMENT, True, True, 0.0, 100.0),
    ]
    red = trace.reduce(evts, (0.0, 100.0))
    assert red["busy_us"] == pytest.approx(30.0 + 5.0 + 5.0)
    assert red["window_us"] == 100.0 and red["kernels"] == 3
    assert red["wrapper_us"] == {"sa_mlp_max": 20.0, "sa_group": 15.0}
    gaps = dict(red["idle_gaps"])
    # 0-10 under aten::linear; 40-55 and 60-95 under the optimizer step
    # (60-70 overlaps aten::mul for 10 us, the step for 30)
    assert gaps == pytest.approx({"aten::linear": 10e-6,
                                  "Optimizer.step#Adam.step": 15e-6 + 35e-6})
    assert [n for n, _ in red["device_ops"]][0].startswith("void (anonymous namespace)::sa_mlp")


@pytest.mark.parametrize("name, wrapper", [
    ("void (anonymous namespace)::fps_kernel<4, 256>(float const*, int const*)", "fps"),
    ("void (anonymous namespace)::ball_warp_kernel<false>(float const*)", "ball_query"),
    ("void (anonymous namespace)::sa_group_warp_kernel<4>(float const*)", "sa_group"),
    ("sa_scatter_kernel(float const*)", "sa_group_scatter"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8", ""),
])
def test_wrapper_of_kernel_names(name, wrapper):
    assert trace.wrapper_of(name) == wrapper
