"""Work spread over several devices: the dispatch contexts' devices
(``devices``) and the ('modules', 'events') grid of the charge step
(``mesh``)."""
